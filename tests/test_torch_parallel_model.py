"""The port's model-parallel forms against the JAX package and one process.

One 4-rank gloo run (``parallel.mesh.run_ranks``: one torch thread a rank,
a file store in ``tmp_path``) does the work of every test here but the
dry run; the parent computes the references and compares. This module
imports JAX only inside its fixtures, so the ranks start without it.

* Tensor parallelism (``parallel/tensor.py``) over a model group of 4: the
  RRDBNet trunk (2 blocks, width 16, 32-px tiles) within 1e-5 of JAX's
  single-device forward with every conv split; the whole tiny flagship
  within 1e-4 (``tests/test_tensor_parallel.py``'s tolerances) with at
  least half of the height model's conv kernels split.
* Spatial parallelism (``parallel/spatial.py``): the trunk on 4 bands of
  rows within 1e-5.
* Pipeline parallelism (``parallel/pipeline.py``): a 4-block trunk at 4
  stages with 4 microbatches and at 2 stages with 8, within 1e-5 of JAX;
  the gradients of a 2-stage, 2-microbatch trunk within 1e-5 of the plain
  trunk's; a generic stage (affine, then tanh for gradients) against the
  sequential program (``tests/test_pipeline_parallel.py``'s shapes); the
  validation errors.
* ``make_city_step(mesh=...)``, ``partition="data"`` over 4 data ranks and
  ``"spatial"`` over 4 model ranks and over a 2 x 2 mesh: byte-equal to
  the plain step.
* ``stitch_tiles_sharded`` over 4 data ranks on 7 tiles: byte-equal to the
  host ``MosaicAccumulator``.
* ``entry.dryrun_multichip(2, device="cpu")``.
"""
import copy

import numpy as np
import pytest
import torch

from srbh_tpu_torch import convert, entry
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.rrdbnet import RRDBNet
from srbh_tpu_torch.parallel import mesh as pmesh
from srbh_tpu_torch.parallel.collectives import rank
from srbh_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    rrdb_pipeline_features,
)
from srbh_tpu_torch.parallel.spatial import (
    gather_rows,
    spatial_parallel,
    split_rows,
)
from srbh_tpu_torch.parallel.tensor import (
    ColumnParallel,
    RowParallel,
    tensor_parallel,
)
from srbh_tpu_torch.predict.device_stitcher import stitch_tiles_sharded
from srbh_tpu_torch.predict.predictor import make_city_step
from srbh_tpu_torch.predict.stitcher import MosaicAccumulator
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

TRUNK_TOL, FLAGSHIP_TOL = 1e-5, 1e-4  # tests/test_tensor_parallel.py
SRC_W, SRC_H, WIN, UP, C = 24, 20, 8, 4, 3  # tests/test_torch_stitcher.py


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _tiles(rng, n):
    t = WIN * UP
    height = rng.randint(0, 2000, (n, t, t)).astype(np.uint16)
    build = rng.randint(0, 256, (n, t, t, C)).astype(np.uint8)
    pos = np.zeros((n, 4), np.int32)
    for i in range(n):
        pos[i, 0] = rng.randint(0, SRC_W - 4)
        pos[i, 1] = rng.randint(0, SRC_H - 4)
        pos[i, 2] = min(WIN, SRC_W - pos[i, 0])
        pos[i, 3] = min(WIN, SRC_H - pos[i, 1])
    pos[n // 2, 2:] = 0
    return height, build, pos


def _models(case):
    trunk = RRDBNet(num_block=2, num_feat=16, num_grow_ch=8)
    trunk.load_state_dict(case["trunk"])
    deep = RRDBNet(num_block=4, num_feat=16, num_grow_ch=8)
    deep.load_state_dict(case["deep"])
    model, sr = entry.modules(tiny=True)
    model.load_state_dict(case["model"])
    sr.load_state_dict(case["sr"])
    return trunk.eval(), deep.eval(), model.eval(), sr.eval()


def _pp_loss_grads(deep, x, mesh=None):
    """The gradients of mean(features^2) through the trunk, plain or
    pipelined (2 microbatches), by parameter name (those it reached)."""
    deep.zero_grad(set_to_none=True)
    y = (deep(x, features_only=True) if mesh is None
         else rrdb_pipeline_features(deep, x, mesh, num_microbatches=2))
    (y ** 2).mean().backward()
    return {n: p.grad.numpy().copy() for n, p in deep.named_parameters()
            if p.grad is not None}


def _split(module) -> int:
    """The layers of ``module`` that ``tensor_parallel`` split."""
    return sum(isinstance(m, (ColumnParallel, RowParallel))
               for m in module.modules())


def _raises(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _rank_model(case_path):
    """Every model-parallel form on this rank; rank 0's results."""
    case = torch.load(case_path, weights_only=False)
    trunk, deep, model, sr = _models(case)
    wide = pmesh.make_mesh(n_model=4)  # 1 x 4
    square = pmesh.make_mesh(n_model=2)  # 2 x 2
    tall = pmesh.make_mesh()  # 4 x 1
    four = wide.get_group(pmesh.MODEL_AXIS)
    out = {}
    x = _nchw(case["x"])
    img = _nchw(case["img"])
    with torch.no_grad():
        tp_trunk = tensor_parallel(trunk, four)
        out["tp_trunk"] = tp_trunk(x, features_only=True).numpy()
        out["tp_trunk_split"] = (_split(tp_trunk), sum(
            isinstance(m, torch.nn.Conv2d) for m in trunk.modules()))
        tp_model, tp_sr = tensor_parallel(model, four), tensor_parallel(sr, four)
        out["tp_flagship"] = [o.numpy() for o in tp_model(
            img, tp_sr(img[:, :3], features_only=True))]
        out["tp_model_split"] = (_split(tp_model), sum(
            isinstance(m, torch.nn.Conv2d) for m in model.modules()))
        band = spatial_parallel(trunk, four)(split_rows(x, four),
                                             features_only=True)
        out["sp_band_rows"] = band.shape[2]
        out["sp_trunk"] = gather_rows(band, four).numpy()
        xd = _nchw(case["x_deep"])
        out["pp4"] = rrdb_pipeline_features(deep, xd, wide,
                                            num_microbatches=4).numpy()
        out["pp2"] = rrdb_pipeline_features(deep, xd, square,
                                            num_microbatches=8).numpy()
        # the serving step's layout: the stages' outputs are channels-last
        cl = torch.channels_last
        out["pp4_channels_last"] = rrdb_pipeline_features(
            copy.deepcopy(deep).to(memory_format=cl),
            xd.contiguous(memory_format=cl), wide,
            num_microbatches=4).numpy()
        w = torch.from_numpy(case["w"])
        out["pp_affine"] = pipeline_apply(lambda p, h: h * p + 1.0, w,
                                          torch.from_numpy(case["mbs"]),
                                          wide).numpy()
    out["pp_grads"] = _pp_loss_grads(deep, _nchw(case["x_deep"]), square)
    w = torch.from_numpy(case["w2"]).requires_grad_(True)
    y = pipeline_apply(lambda p, h: torch.tanh(h * p), w,
                       torch.from_numpy(case["mbs2"]), wide)
    (y ** 2).sum().backward()
    out["pp_w_grad"] = w.grad.numpy()
    out["errors"] = {
        "microbatches": _raises(lambda: rrdb_pipeline_features(
            deep, xd, wide, num_microbatches=3)),
        "zero": _raises(lambda: rrdb_pipeline_features(
            deep, xd, wide, num_microbatches=0)),
        "blocks": _raises(lambda: rrdb_pipeline_features(trunk, x, wide)),
        "stages": _raises(lambda: pipeline_apply(
            lambda p, h: h, [torch.zeros(1)] * 3, torch.zeros(2, 1, 4), wide)),
        "spatial rows": _raises(lambda: make_city_step(
            model, sr, dtype=torch.float32, device="cpu", mesh=wide,
            partition="spatial")(case["img"][:, :30, :30])),
        "mesh model": _raises(lambda: pmesh.make_mesh(n_model=3)),
        "mesh cover": _raises(lambda: pmesh.make_mesh(n_data=3)),
        "data batch": _raises(lambda: make_city_step(
            model, sr, dtype=torch.float32, device="cpu", mesh=tall)(
            case["img"][:3])),
    }
    for name, mesh, partition in (("data", tall, "data"),
                                  ("spatial", wide, "spatial"),
                                  ("spatial 2x2", square, "spatial")):
        step = make_city_step(model, sr, dtype=torch.float32, device="cpu",
                              mesh=mesh, partition=partition)
        out[f"city {name}"] = [o.numpy() for o in step(case["img"])]
    out["stitch"] = [c.numpy() for c in stitch_tiles_sharded(
        *case["tiles"], (SRC_H * UP, SRC_W * UP), tall, UP)]
    return out if rank() == 0 else None


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Seeded weights (the RRDBNets from JAX's init, the height model from
    the port's, carried to JAX by ``convert.height_model_variables``), the
    inputs, JAX's single-device outputs, and the 4 ranks' results."""
    import jax
    import jax.numpy as jnp

    from srbh_tpu import models as jmodels

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    x_deep = rng.uniform(0, 1, (8, 16, 16, 3)).astype(np.float32)
    img = rng.uniform(0, 1, (4, 32, 32, 8)).astype(np.float32)
    case = {"x": x, "x_deep": x_deep, "img": img}
    jax_out = {}
    for key, blocks, inp in (("trunk", 2, x), ("deep", 4, x_deep),
                             ("sr", 2, img[..., :3])):
        jsr = jmodels.RRDBNet(num_block=blocks, num_feat=16, num_grow_ch=8)
        params = jax.jit(jsr.init)(jax.random.PRNGKey(len(key)),
                                   jnp.asarray(inp))
        case[key] = convert.rrdbnet_state_dict(jax.device_get(params), blocks)
        jax_out[key] = np.asarray(jax.jit(
            lambda p, im, m=jsr: m.apply(p, im, features_only=True))(
                params, jnp.asarray(inp)))
        if key == "sr":
            sr_params = params
    model, _ = entry.modules(tiny=True)
    init_weights(model, torch.Generator().manual_seed(3))
    stats = {k: v for k, v in model.state_dict().items()}
    srng = np.random.default_rng(4)
    for k in stats:  # non-trivial running statistics, a lifted height bias
        if k.endswith("running_mean"):
            stats[k] = torch.from_numpy(srng.normal(0, 0.1, stats[k].shape)
                                        .astype(np.float32))
        elif k.endswith("running_var"):
            stats[k] = torch.from_numpy(srng.uniform(0.5, 1.5, stats[k].shape)
                                        .astype(np.float32))
    stats["reg.conv_last.bias"] = torch.full((1,), 2.0)
    case["model"] = stats
    jm = jmodels.SRRegressClsFeature(encoder_name="efficientnet-test",
                                     super_mid=8, isaggre=True, chans_build=7)
    variables = convert.height_model_variables(stats, True,
                                               "efficientnet-test")
    fea = jax.jit(lambda p, im: jmodels.RRDBNet(
        num_block=2, num_feat=16, num_grow_ch=8).apply(
            p, im[..., :3], features_only=True))(sr_params, jnp.asarray(img))
    jax_out["flagship"] = [np.asarray(o) for o in jax.jit(
        lambda v, im, f: jm.apply(v, im, f, train=False))(
            variables, jnp.asarray(img), fea)]
    case["w"] = rng.uniform(0.5, 1.5, (4, 1)).astype(np.float32)
    case["mbs"] = rng.normal(size=(6, 2, 3)).astype(np.float32)
    case["w2"] = rng.uniform(0.5, 1.5, (4, 1)).astype(np.float32)
    case["mbs2"] = rng.normal(size=(4, 2, 3)).astype(np.float32)
    case["tiles"] = _tiles(np.random.RandomState(1), 7)
    path = tmp_path_factory.mktemp("model_case") / "case.pt"
    torch.save(case, path)
    ranked = pmesh.run_ranks(_rank_model, 4, str(path),
                             workdir=str(tmp_path_factory.mktemp("ranks")))
    return case, jax_out, ranked[0]


def _nhwc(a):
    return a.transpose(0, 2, 3, 1)


def test_trunk_tp_matches_jax(refs):
    case, jax_out, got = refs
    np.testing.assert_allclose(_nhwc(got["tp_trunk"]), jax_out["trunk"],
                               atol=TRUNK_TOL, rtol=0)
    split, convs = got["tp_trunk_split"]
    assert split >= convs - 1  # every conv (conv_last row-parallel)


def test_flagship_tp_matches_jax(refs):
    case, jax_out, got = refs
    h, b, a = got["tp_flagship"]
    for o, r, name in zip((h, b, a), jax_out["flagship"],
                          ("height", "build", "aggre")):
        np.testing.assert_allclose(_nhwc(o), r, atol=FLAGSHIP_TOL, rtol=0,
                                   err_msg=name)
    split, convs = got["tp_model_split"]
    assert split >= convs // 2, (split, convs)


def test_trunk_sp_matches_jax(refs):
    case, jax_out, got = refs
    assert got["sp_band_rows"] == 4 * 32 // 4  # each rank held a quarter
    np.testing.assert_allclose(_nhwc(got["sp_trunk"]), jax_out["trunk"],
                               atol=TRUNK_TOL, rtol=0)


@pytest.mark.parametrize("key", ["pp4", "pp2", "pp4_channels_last"])
def test_rrdb_pipeline_matches_jax(refs, key):
    case, jax_out, got = refs
    np.testing.assert_allclose(_nhwc(got[key]), jax_out["deep"],
                               atol=TRUNK_TOL, rtol=0)


def test_generic_pipeline_matches_sequential(refs):
    case, _, got = refs
    want = case["mbs"]
    for s in range(4):
        want = want * case["w"][s] + 1.0
    np.testing.assert_allclose(got["pp_affine"], want, rtol=1e-6)


def test_pipeline_gradients_match_sequential(refs):
    """Through the tanh stages: rank 0 holds stage 0's row of the weight's
    gradient; the sequential program's, from autograd, row 0 alike, and
    the others 0 on that rank."""
    case, _, got = refs
    w = torch.from_numpy(case["w2"]).requires_grad_(True)
    h = torch.from_numpy(case["mbs2"])
    for s in range(4):
        h = torch.tanh(h * w[s])
    (h ** 2).sum().backward()
    np.testing.assert_allclose(got["pp_w_grad"][0], w.grad.numpy()[0],
                               rtol=1e-5)
    assert not got["pp_w_grad"][1:].any()


def test_rrdb_pipeline_gradients_match_plain(refs):
    """2 stages, 2 microbatches: rank 0 (stage 0: blocks 0 and 1) has the
    plain trunk's gradients of ``conv_first``, its blocks and the tail,
    within 1e-5, and none of stage 1's blocks."""
    case, _, got = refs
    _, deep, _, _ = _models(case)
    want = _pp_loss_grads(deep, _nchw(case["x_deep"]))
    have = got["pp_grads"]
    assert not any(n.startswith(("body.2.", "body.3.")) for n in have)
    for name in ("conv_first.weight", "body.1.rdb2.conv3.weight",
                 "conv_hr.weight"):
        assert name in have
    for name, g in have.items():
        np.testing.assert_allclose(g, want[name], atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("case_name,match", [
    ("microbatches", "ValueError: batch 8 not divisible by 3"),
    ("zero", "ValueError: num_microbatches must be >= 1"),
    ("blocks", "ValueError: num_block=2 not divisible by 4 stages"),
    ("stages", "ValueError: stage_params leading dim"),
    ("spatial rows", "ValueError: 30 rows do not divide over 4"),
    ("data batch", "ValueError: batch of 3 does not divide over 4"),
    ("mesh model", "ValueError: 4 ranks do not divide over n_model=3"),
    ("mesh cover", "ValueError: mesh 3x1 does not cover the 4 ranks"),
])
def test_validation_errors(refs, case_name, match):
    assert refs[2]["errors"][case_name].startswith(match), \
        refs[2]["errors"][case_name]


def test_pipeline_refuses_a_quantised_trunk():
    sr = RRDBNet(num_block=2, num_feat=8, num_grow_ch=8, quantize=True)
    with pytest.raises(NotImplementedError, match="JAX package refuses it too"):
        rrdb_pipeline_features(sr, torch.zeros(1, 3, 8, 8), None)


@pytest.mark.parametrize("name", ["data", "spatial", "spatial 2x2"])
def test_city_step_on_a_mesh_is_byte_equal(refs, name):
    case, _, got = refs
    _, _, model, sr = _models(case)
    want = make_city_step(model, sr, dtype=torch.float32, device="cpu")(
        case["img"])
    for g, w in zip(got[f"city {name}"], want):
        assert g.dtype == w.numpy().dtype
        np.testing.assert_array_equal(g, w.numpy())


def test_sharded_stitcher_is_byte_equal_to_the_host(refs):
    case, _, got = refs
    height, build, pos = case["tiles"]
    host = MosaicAccumulator(SRC_W, SRC_H, C, upscale=UP)
    host.add_batch_plain(height, build.astype(np.uint16), pos)
    hs, bs, wt = got["stitch"]
    np.testing.assert_array_equal(hs, host.height_sum)
    np.testing.assert_array_equal(bs.transpose(2, 0, 1), host.build_sum)
    np.testing.assert_array_equal(wt, host.weight)
    assert wt.max() >= 2


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    line = entry.dryrun_multichip(2, device="cpu")
    assert line.startswith("dryrun_multichip(2): loss=")
    for part in ("devices=2", "predict+stitch=ok", "fsdp=ok",
                 "tp=ok(trunk+flagship)", "sp=ok", "pp=ok", "gan_dp=ok"):
        assert part in line
    assert line in capsys.readouterr().out


def test_dryrun_multichip_needs_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        entry.dryrun_multichip(2)



