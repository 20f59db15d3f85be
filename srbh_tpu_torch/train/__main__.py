"""``python -m srbh_tpu_torch.train [flags of train.py]``: train the height
model on the card with the port (the flags are the JAX package's, see
``train/config.py``)."""
from srbh_tpu_torch.train.config import get_args
from srbh_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main(get_args())
