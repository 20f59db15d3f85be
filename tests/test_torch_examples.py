"""The port's examples, end to end on the CPU at their tiny sizes.

* ``examples.quickstart``: synthetic tiles -> ``trainer.main`` (2 epochs) ->
  ``main_test`` -> a city mosaic, through ``device="cpu"``, with no pandas;
  its dataset feeds the loader, and its outputs exist and are finite.
* ``examples.parallel_modes``: DP, FSDP, TP, SP and PP over 2 gloo ranks,
  each within ``TOL`` of the plain forward.

(``tests/test_torch_port_rules.py`` holds both ``main``s to the card by
default.)
"""
import os

import numpy as np

from srbh_tpu_torch.data.dataset import S12GlobeDataset
from srbh_tpu_torch.data.tiff import read_tiff
from srbh_tpu_torch.examples import parallel_modes, quickstart
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


def test_quickstart_runs_end_to_end(tmp_path, capsys):
    root = str(tmp_path / "qs")
    build_tif, height_tif = quickstart.main(root, device="cpu")
    out = capsys.readouterr().out
    assert "trained 4 steps" in out
    logs = os.listdir(os.path.join(root, "logs"))
    assert {"checkpoint", "acc2demo_100.txt", "acc2demo_100_seg.csv",
            "acc2demo_100_he.csv"} <= set(logs)
    height, build = read_tiff(height_tif), read_tiff(build_tif)
    assert height.shape[:2] == build.shape[:2] == (400, 520)  # 4x the city
    assert np.isfinite(height.astype(np.float64)).all()
    cfg = quickstart.tiny_config(root, os.path.join(root, "data"),
                                 os.path.join(root, "stats"))
    ds = S12GlobeDataset(os.path.join(cfg.datapath, cfg.trainlist),
                         cfg.datapath, datastats=cfg.datastats,
                         s1dir="s1c", s2dir="s2c", heightdir="bhc",
                         preweight=cfg.preweight, isaggre=True, ishir=True)
    s = ds[0]
    assert s["image"].shape == (32, 32, 8) and np.isfinite(s["image"]).all()


def test_parallel_modes_over_two_gloo_ranks(capsys):
    diffs = parallel_modes.main(2, device="cpu")
    assert sorted(diffs) == ["DP", "FSDP", "PP", "SP", "TP"]
    assert max(diffs.values()) <= parallel_modes.TOL
    assert "all five modes match" in capsys.readouterr().out
