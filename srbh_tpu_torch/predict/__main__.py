"""``python -m srbh_tpu_torch.predict [flags of predict_realesanet_feature_globe.py]``:
the 301-urban-center predictor on the card.

Counterpart of predict_realesanet_feature_globe.py:12-44: the flags of
``train/config.py`` (``get_args(city="globe")``), the checkpoint
``<logdir>/checkpoint20`` (a file of the port's ``save_checkpoint``, or the
JAX package's ``checkpoint20.npz``), the frozen SR weights from
``--logdirhr``, then every city of the six urban-center groups under
``<datapath>/urban/input_data/s2<group>`` in bfloat16, batches of 16, host
stitching, written to ``<logdir>/pred_<epoch>_city<group>``.
"""
import os
import sys

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.predict.predictor import city_names_from_dir, predict_cities
from srbh_tpu_torch.train.checkpoint import load_checkpoint, restore_into_state
from srbh_tpu_torch.train.config import get_args
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.trainer import build_models, load_sr_weights

ISONAMES = ("chn_large", "usa_large", "europe_large",
            "chn_metro", "usa_metro", "europe_metro")


def main(argv=None, device=None):
    """Predict every city under ``--datapath`` on ``device`` (``None`` is
    the card; without one this raises). Returns the (build, height) tif
    paths, city by city."""
    dev = resolve_device(device)
    args = get_args(city="globe", argv=argv)
    args.checkpoint = "checkpoint20"
    if os.environ.get("SRBH_PACKED", "") == "1":
        raise NotImplementedError("SRBH_PACKED=1 (the space-to-depth compute "
                                  "mode) is not ported: ROADMAP.md Queue 1 "
                                  "item 15")
    model, sr = build_models(args)
    load_sr_weights(args, sr)
    path = os.path.join(args.logdir, args.checkpoint)
    if not os.path.isfile(path) and os.path.isfile(path + ".npz"):
        path += ".npz"
    payload = load_checkpoint(path, args.encoder_name, args.isaggre)
    if payload is None:
        raise SystemExit(f"no checkpoint at {args.logdir}/{args.checkpoint}")
    restore_into_state(TrainState(model, n_log_vars=3 if args.isaggre else 2,
                                  lr=args.lr), payload)

    results = []
    for isoname in ISONAMES:
        wholeimgpath = os.path.join(args.datapath, "urban", "input_data",
                                    "s2" + isoname)
        if not os.path.isdir(wholeimgpath):
            continue
        respath = os.path.join(args.logdir,
                               f"pred_{payload['epoch']}_city{isoname}")
        os.makedirs(respath, exist_ok=True)
        results += predict_cities(
            wholeimgpath, city_names_from_dir(wholeimgpath), model, sr,
            args.datastats, respath, s1dir=args.s1dir, s2dir=args.s2dir,
            gridvalid="isv", nchans=args.nchanss2,
            chans_build=args.chans_build, batch_size=16, device=dev)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
