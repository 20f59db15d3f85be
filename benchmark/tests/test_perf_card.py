"""On the card only (marked ``gpu``; skipped without one, decided inside a
fixture): the tiny serving cell through ``run.main`` as a run makes it,
the result naming the card."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark import run

from conftest import make_root


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("trace", ["0", "1"])
def test_tiny_serving_cell_on_the_card(card, trace, tmp_path, capsys):
    root = make_root(str(tmp_path))
    rc = run.main(["--workload", "flagship_tiny.serve_tiny", "--seed",
                   str(2**31 + 7), "--seconds", "1", "--trace", trace],
                  device=card, root=root)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
    if trace == "1":
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"]
