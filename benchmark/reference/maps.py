"""The comparison of served maps with the reference's.

The port returns each tile's height as uint16 decimetres and its build
softmax as uint8 (x 255). The reference computes the same maps twice from
the same inputs and weights: in float32 (TF32 off), the truth, and in the
configuration's compute type (``torch.autocast`` in bfloat16, as the
configuration states the port runs), quantised as the port quantises: the
yardstick of what that type's rounding alone costs on this seed's weights
and tiles. Each tile's root-mean-square error against the truth is taken
on both sides; two numbers over every tile compared, each the program's
worst tile over the yardstick's worst tile:

* ``height_tile_ratio``: of the heights, in metres;
* ``build_tile_ratio``: of the build softmax.

A sound program in the stated type reads about 1 on every seed, whatever
the seed's weights make of the scale of the errors (which moves the plain
errors tenfold from seed to seed); one a precision lower reads several
times that, and one wrong tile among many reads its own error, not a share
of the batch's.
"""
from __future__ import annotations

import torch


def _tile_sq(a_int, scale, ref):
    """Each tile's mean square error, (B,) float64 on the host."""
    d = a_int.cpu().to(torch.int32).double() / scale - ref.cpu().double()
    return d.pow(2).flatten(1).mean(1)


class MapCheck:
    """Accumulates batches: the program's maps, the truth's float maps and
    the yardstick's quantised maps."""

    def __init__(self):
        self.tiles = {"h": [], "b": [], "yh": [], "yb": []}
        self.refs = []

    def add(self, h_u16, b_u8, h_ref, p_ref, yard_h, yard_b):
        self.tiles["h"].append(_tile_sq(h_u16, 10.0, h_ref))
        self.tiles["yh"].append(_tile_sq(yard_h, 10.0, h_ref))
        self.tiles["b"].append(_tile_sq(b_u8, 255.0, p_ref))
        self.tiles["yb"].append(_tile_sq(yard_b, 255.0, p_ref))
        self.refs.append(h_ref.double().flatten().cpu())

    def _worst(self, key) -> float:
        return float(torch.cat(self.tiles[key]).max()) ** 0.5

    def readings(self) -> dict:
        def ratio(p, y):
            return self._worst(p) / max(self._worst(y), 1e-30)
        return {"height_tile_ratio": ratio("h", "yh"),
                "build_tile_ratio": ratio("b", "yb")}

    def stats(self) -> dict:
        ref = torch.cat(self.refs)
        t = {k: torch.cat(v) for k, v in self.tiles.items()}
        return {"pixels": int(ref.numel()), "tiles": int(t["h"].numel()),
                "height_mean_m": float(ref.mean()),
                "height_std_m": float(ref.std()),
                "height_zero_share": float((ref == 0).double().mean()),
                "height_rms_m": float(t["h"].mean()) ** 0.5,
                "yardstick_height_rms_m": float(t["yh"].mean()) ** 0.5,
                "yardstick_worst_tile_m": float(t["yh"].max()) ** 0.5,
                "build_rms": float(t["b"].mean()) ** 0.5,
                "yardstick_build_rms": float(t["yb"].mean()) ** 0.5}
