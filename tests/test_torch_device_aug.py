"""The port's in-step augmentation and targets against the JAX package's.

``srbh_tpu_torch.ops.device_aug`` and ``ops.aggregate`` against
``srbh_tpu.ops.device_aug`` / ``ops.aggregate``, fed the same numpy inputs
and, for the random transforms, JAX's own draws (the port draws from a
``torch.Generator``; threefry cannot be reproduced):

* flips, 2x2 grid shuffles, ``_reflect101`` and the zero angle: exact;
* the nearest mask rotation: exact on JAX's angles; the bilinear low-res
  rotation within 1e-5 of JAX on the same angle;
* ``build_targets`` and ``aggregate`` (both modes): bit-equal on integer
  heights;
* a whole batch through ``augment_batch`` on JAX's per-sample draws: images
  within 1e-5, heights exact;
* the port's draws: each branch with p = 0.5 and the angle uniform on
  [-90, 90), within 4 sigma;
* the dataset's ``device_aug`` / ``device_norm`` samples against the JAX
  dataset's, and its guards;
* ``make_train_step(device_aug=True)`` (with and without ``norm``) against
  the port's plain step fed the targets JAX's ``build_targets`` makes from
  the same augmented batch: losses within 1e-5, parameters after one step
  equal;
* ``trainer.main`` with ``--device_norm`` and ``--device_aug`` trains.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.data.dataset import S12GlobeDataset as JaxDataset
from srbh_tpu.ops import device_aug as jda
from srbh_tpu.ops.aggregate import aggregate as jax_aggregate
from srbh_tpu.ops.hierarchy import DEFAULT_HIR, build_hierarchy_lut, hierweight
from srbh_tpu_torch.data.dataset import S12GlobeDataset
from srbh_tpu_torch.data.tiff import write_tiff
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.ops import aggregate as tagg
from srbh_tpu_torch.ops import device_aug as tda
from srbh_tpu_torch.train.config import get_args
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.steps import make_train_step, step_seed
from srbh_tpu_torch.train.trainer import main
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

ANGLES = [-73.4, -30.0, 12.7, 45.0, 88.9]


def _pair(seed=0, n=None, h=16, w=16, c=8, scale=4):
    rng = np.random.default_rng(seed)
    lead = () if n is None else (n,)
    img = rng.uniform(0, 1, lead + (h, w, c)).astype(np.float32)
    height = rng.integers(0, 120, lead + (h * scale, w * scale)).astype(np.float32)
    return img, height


def _one(x):
    return torch.from_numpy(np.ascontiguousarray(x))[None]


@pytest.mark.parametrize("d", [-1, 0, 1])
def test_flip_equals_jax(d):
    img, height = _pair()
    yes, code = torch.tensor([True]), torch.tensor([d])
    for a in (img, height):
        want = np.asarray(jda.flip(jnp.asarray(a), jnp.int32(d)))
        np.testing.assert_array_equal(tda.flip(_one(a), code, yes)[0].numpy(), want)
        np.testing.assert_array_equal(
            tda.flip(_one(a), code, torch.tensor([False]))[0].numpy(), a)


def test_grid_shuffle_equals_jax():
    img, height = _pair(1)
    rng = np.random.default_rng(3)
    for _ in range(6):
        order = rng.permutation(4)
        for a in (img, height):
            want = np.asarray(jda.grid_shuffle_2x2(jnp.asarray(a), jnp.asarray(order)))
            got = tda.grid_shuffle_2x2(_one(a), torch.from_numpy(order)[None],
                                       torch.tensor([True]))[0].numpy()
            np.testing.assert_array_equal(got, want)


def test_reflect101_and_zero_angle_equal_jax():
    idx = np.arange(-20, 40)
    for n in (1, 2, 8, 17):
        np.testing.assert_array_equal(
            tda._reflect101(torch.from_numpy(idx), n).numpy(),
            np.asarray(jda._reflect101(jnp.asarray(idx), n)))
    img, height = _pair(5)
    zero = torch.zeros(1)
    np.testing.assert_array_equal(tda.rotate_image_lowres(_one(img), zero)[0].numpy(),
                                  img)
    np.testing.assert_array_equal(tda.rotate_mask_nearest(_one(height), zero)[0].numpy(),
                                  height)


@pytest.mark.parametrize("angle", ANGLES)
def test_rotations_match_jax(angle):
    img, height = _pair(2)
    a32 = np.float32(angle)
    want_m = np.asarray(jda.rotate_mask_nearest(jnp.asarray(height), jnp.float32(a32)))
    want_i = np.asarray(jda.rotate_image_lowres(jnp.asarray(img), jnp.float32(a32)))
    at = torch.tensor([a32])
    np.testing.assert_array_equal(tda.rotate_mask_nearest(_one(height), at)[0].numpy(),
                                  want_m)
    np.testing.assert_allclose(tda.rotate_image_lowres(_one(img), at)[0].numpy(),
                               want_i, atol=1e-5, rtol=0)


@pytest.mark.parametrize("isaggre", [True, False])
def test_build_targets_bit_equal_to_jax(isaggre):
    rng = np.random.default_rng(7)
    height = rng.integers(0, 256, (3, 64, 64)).astype(np.float32)
    lut = build_hierarchy_lut(DEFAULT_HIR)
    cw = hierweight(rng.uniform(1, 100, 256), DEFAULT_HIR).astype(np.float32)
    want = jax.jit(lambda h: jda.build_targets(
        h, jnp.asarray(lut), jnp.asarray(cw), isaggre=isaggre))(jnp.asarray(height))
    got = tda.build_targets(torch.from_numpy(height).to(torch.uint8), lut, cw,
                            isaggre=isaggre)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == {np.dtype("int32"): torch.int32,
                                np.dtype("float32"): torch.float32}[v.dtype], k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("inclusive,eps", [(True, 1e-10), (False, 1e-6)])
def test_aggregate_bit_equal_to_jax(inclusive, eps):
    rng = np.random.default_rng(8)
    height = rng.integers(0, 100, (2, 3, 64, 64)).astype(np.float32)
    height[0, 0, :8] = 0  # blocks with no valid pixel in the exclusive mode
    want = np.asarray(jax_aggregate(jnp.asarray(height), 0.25, 0.0, inclusive, eps))
    got = tagg.aggregate(torch.from_numpy(height), 0.25, 0.0, inclusive, eps)
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_draws(key, n):
    """The draws ``jda.augment_batch`` takes from ``key``, per sample."""
    def one(k):
        kf, kd, ks, kp, kr, ka = jax.random.split(k, 6)
        return (jax.random.uniform(kf) < 0.5, jax.random.randint(kd, (), -1, 2),
                jax.random.uniform(ks) < 0.5, jax.random.permutation(kp, 4),
                jax.random.uniform(kr) < 0.5,
                jax.random.uniform(ka, (), minval=-90.0, maxval=90.0))

    f, d, s, o, r, a = (np.array(x) for x in
                        jax.vmap(one)(jax.random.split(key, n)))
    return {"flip": torch.from_numpy(f), "flip_code": torch.from_numpy(d).long(),
            "shuffle": torch.from_numpy(s), "order": torch.from_numpy(o).long(),
            "rotate": torch.from_numpy(r), "angle": torch.from_numpy(a)}


def test_augment_batch_on_jax_draws_equals_jax():
    img, height = _pair(9, n=16)
    key = jax.random.PRNGKey(4)
    draws = _jax_draws(key, 16)
    assert 0 < int(draws["rotate"].sum()) < 16
    wi, wh = jda.augment_batch(key, jnp.asarray(img), jnp.asarray(height.astype(np.uint8)))
    gi, gh = tda.augment_batch(torch.from_numpy(img),
                               torch.from_numpy(height.astype(np.uint8)), draws)
    assert gh.dtype == torch.uint8
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-5, rtol=0)


def test_port_draws_branch_probabilities_and_angle_law():
    n = 4000
    d = tda.draw_augment(n, torch.Generator().manual_seed(0))
    sigma = (0.25 / n) ** 0.5
    for k in ("flip", "shuffle", "rotate"):
        assert abs(d[k].double().mean().item() - 0.5) < 4 * sigma, k
    for v in (-1, 0, 1):
        assert abs((d["flip_code"] == v).double().mean().item() - 1 / 3) < 0.03
    assert sorted(d["order"][0].tolist()) == [0, 1, 2, 3]
    assert (d["order"].sort(1).values == torch.arange(4)).all()
    first = torch.bincount(d["order"][:, 0], minlength=4).double() / n
    assert (first - 0.25).abs().max().item() < 0.03
    a = d["angle"].double()
    assert a.min() >= -90 and a.max() < 90
    assert abs(a.mean().item()) < 4 * (180 ** 2 / 12 / n) ** 0.5
    again = tda.draw_augment(n, torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], d[k]) for k in d)


# ------------------------------------------------------------ dataset, step


def _write_tiles(root, n=8, side=32):
    rng = np.random.default_rng(0)
    names = [f"t_{i}.tif" for i in range(n)]
    for d in ("s2c", "s1c", "bhc"):
        os.makedirs(root / d)
    gt = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
    for name in names:
        write_tiff(str(root / "s2c" / name),
                   rng.integers(0, 5000, (side, side, 6)).astype(np.uint16), gt)
        write_tiff(str(root / "s1c" / name),
                   rng.uniform(-25, 5, (side, side, 2)).astype(np.float32), gt)
        write_tiff(str(root / "bhc" / name),
                   rng.integers(0, 100, (4 * side, 4 * side)).astype(np.uint8),
                   (gt[0], 2.5, 0.0, gt[3], 0.0, -2.5))
    for split in ("train", "val"):
        with open(root / f"dl_{split}.csv", "w") as f:
            f.writelines(f"{name},s1c,s2c,bhc\n" for name in names)
    # a narrow table, so normalised values leave [0, 1] and clipping matters
    np.savetxt(root / "s2c_minmax.txt",
               np.stack([np.full(6, 1000.0), np.full(6, 4000.0)]))
    np.savetxt(root / "s1c_minmax.txt", np.stack([np.full(2, -25.0), np.full(2, 5.0)]))
    hist = np.zeros(256)
    hist[:100] = 1000
    np.savetxt(root / "bh_stats.txt", hist)


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    root = tmp_path_factory.mktemp("device_aug_tiles")
    _write_tiles(root)
    return root


def _ds_kw(root):
    return dict(datastats=str(root), normmethod="minmax", datarange=(0, 1),
                s1dir="s1c", s2dir="s2c", heightdir="bhc", isaggre=True,
                ishir=True, preweight=str(root / "bh_stats.txt"), seed=0)


def test_dataset_modes_equal_jax(tiles):
    kw = _ds_kw(tiles)
    dl = str(tiles / "dl_train.csv")
    for mode in ({"device_aug": True}, {"device_aug": True, "device_norm": True}):
        port = S12GlobeDataset(dl, str(tiles), aug=False, **mode, **kw)
        jds = JaxDataset(dl, str(tiles), aug=False, **mode, **kw)
        for i in (0, 5):
            got, want = port[i], jds[i]
            assert set(got) == set(want)
            for k, v in want.items():
                if k == "path":
                    assert got[k] == v
                else:
                    assert got[k].dtype == v.dtype, k
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
    with pytest.raises(ValueError, match="device_aug"):
        S12GlobeDataset(dl, str(tiles), aug=True, device_aug=True, **kw)
    with pytest.raises(ValueError, match="device_norm requires device_aug"):
        S12GlobeDataset(dl, str(tiles), aug=False, device_norm=True, **kw)
    with pytest.raises(FileNotFoundError, match="device_norm needs both"):
        S12GlobeDataset(dl, str(tiles), aug=False, device_aug=True,
                        device_norm=True, **dict(kw, datastats=str(tiles / "s2c")))


def _tiny_model():
    model = SRRegressClsFeature("efficientnet-test", super_mid=8, isaggre=True,
                                chans_build=7, sr_chans=8,
                                decoder_channels=(32, 24, 16, 12, 8),
                                drop_connect_rate=0.0)
    return init_weights(model, torch.Generator().manual_seed(0))


class FixedFeature(torch.nn.Module):
    def __init__(self, n, side):
        super().__init__()
        self.register_buffer("fea", torch.randn(
            n, 8, side, side, generator=torch.Generator().manual_seed(1)))

    def forward(self, x, features_only=True):
        return self.fea


@pytest.mark.parametrize("norm", [False, True])
def test_device_aug_step_equals_plain_step_on_jax_targets(tiles, norm):
    kw = _ds_kw(tiles)
    dl = str(tiles / "dl_train.csv")
    ds = S12GlobeDataset(dl, str(tiles), aug=False, device_aug=True,
                         device_norm=norm, **kw)
    samples = [ds[i] for i in range(4)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0] if k != "path"}
    stats = {k: getattr(ds, k) for k in ("s2_off", "s2_scale", "s1_off", "s1_scale")}
    fea = FixedFeature(4, 128)
    seed, lr = 3, 1e-3

    # the step's own draws, its normalisation (float64, as the host's) and
    # clip, then JAX's targets
    if norm:
        image = np.concatenate(
            [(batch[k].astype(np.float64) - stats[f"{k}_off"])
             / stats[f"{k}_scale"] for k in ("s2", "s1")], -1)
        image = image.astype(np.float32)
    else:
        image = batch["image"]
    gen = torch.Generator().manual_seed(step_seed(seed, 0, tda.AUG_TAG))
    img, height = tda.augment_batch(torch.from_numpy(image),
                                    torch.from_numpy(batch["height"]),
                                    tda.draw_augment(4, gen))
    if norm:
        img = img.clamp(0, 1)
    targets = jax.jit(lambda h: jda.build_targets(
        h, jnp.asarray(ds.buildhir), jnp.asarray(ds.heightweight),
        isaggre=True))(jnp.asarray(height.numpy()))
    plain_batch = {"image": img.numpy(),
                   **{k: np.array(v) for k, v in targets.items()}}

    runs = {}
    for name, step_kw, b in (
            ("device_aug", dict(device_aug=True, hir=DEFAULT_HIR,
                                class_weight=ds.heightweight,
                                norm=stats if norm else None), batch),
            ("plain", {}, plain_batch)):
        model = _tiny_model()
        state = TrainState(model)
        step = make_train_step(model, fea, seed=seed, device="cpu", **step_kw)
        m = step(state, b, lr)
        runs[name] = (m, {n: p.detach().clone() for n, p in model.named_parameters()})
    (m_a, p_a), (m_p, p_p) = runs["device_aug"], runs["plain"]
    for k in ("loss", "rmse"):
        assert m_a[k].item() == pytest.approx(m_p[k].item(), rel=1e-5, abs=1e-5), k
    torch.testing.assert_close(m_a["log_vars"], m_p["log_vars"], rtol=0, atol=1e-6)
    for n, p in p_p.items():
        torch.testing.assert_close(p_a[n], p, rtol=0, atol=0, msg=n)


def test_device_aug_step_refuses_what_jax_refuses():
    model = _tiny_model()
    with pytest.raises(ValueError, match="requires device_aug"):
        make_train_step(model, None, norm={}, device="cpu")
    with pytest.raises(ValueError, match="ishir"):
        make_train_step(model, None, device_aug=True, ishir=False, device="cpu")


@pytest.mark.parametrize("flag", ["--device_norm", "--device_aug"])
def test_trainer_main_trains_with_in_step_augmentation(tiles, tmp_path, flag):
    argv = ["--datapath", str(tiles), "--trainlist", "dl_train.csv",
            "--vallist", "dl_val.csv", "--logdir", str(tmp_path / "logs"),
            "--logdirhr", str(tmp_path / "no_sr"), "--datastats", str(tiles),
            "--preweight", str(tiles / "bh_stats.txt"), "--s1dir", "s1c",
            "--s2dir", "s2c", "--bhdir", "bhc", "--maxepoch", "1",
            "--batch_size", "4", "--num_workers", "0", "--encoder_name",
            "efficientnet-test", "--super_mid", "8", "--sr_num_block", "1",
            "--sr_num_feat", "8", "--sr_num_grow", "8", "--tile", "32", flag, "true"]
    cfg = get_args(argv=argv)
    assert cfg.device_aug or cfg.device_norm
    model0 = {k: v.clone() for k, v in _tiny_state(cfg).items()}
    state = main(cfg, max_steps_per_epoch=2, device="cpu")
    assert state.step == 2
    assert os.path.isfile(tmp_path / "logs" / "checkpoint")
    assert torch.isfinite(state.log_vars).all() and (state.log_vars != 0).all()
    moved = [k for k, v in state.model.state_dict().items()
             if k.endswith("weight") and not torch.equal(v, model0[k])]
    assert moved


def _tiny_state(cfg):
    from srbh_tpu_torch.train.trainer import build_models

    return build_models(cfg)[0].state_dict()
