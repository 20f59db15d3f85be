"""``python -m srbh_tpu_torch.train [flags of train.py]``: the reference's
``python train.py`` on the card.

The counterpart of the repository's ``train.py`` (train.py:489-504): train
the globe height model for 20 epochs, then evaluate ``checkpoint20`` on the
globe test list (its first 100 tiles) and on the whole test lists of china,
eu and usa, writing each one's acc txt / csv files. The flags are the JAX
package's (``train/config.py``).
"""
import sys

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.train import trainer
from srbh_tpu_torch.train.config import get_args


def main(argv=None, device=None):
    """Run the sequence on ``device`` (``None`` is the card; without one
    this raises unless ``device="cpu"``); returns ``main_test``'s results,
    globe first."""
    dev = resolve_device(device)
    args = get_args(city="globe", argv=argv)
    args.maxepoch = 20  # "20 is enough" (train.py:491)
    trainer.main(args, device=dev)
    args.checkpoint = "checkpoint20"
    results = [trainer.main_test(args, num_sample=100, device=dev)]
    for city in ("china", "eu", "usa"):
        args.testlist = f"datalist_{city}_test_0.7_test_0.3.csv"
        results.append(trainer.main_test(args, num_sample=0, suffix=city,
                                         device=dev))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
