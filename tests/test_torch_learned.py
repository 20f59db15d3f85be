"""The port's LPIPS, CLIP / CLIPA / SigLIP towers and learned metrics
against the JAX package's.

Each tower is built at a small width (LPIPS at its full, small width) with
seeded random weights, random LayerNorm affines and biases; its
``state_dict`` goes through the JAX package's converters
(``convert_lpips_alex``, ``convert_clip_visual``,
``convert_siglip_visual``) and both run on one seeded input:

* tower outputs within 1e-4 of their largest magnitude;
* the port's carry (``srbh_tpu_torch.convert``) of the JAX tree gives back
  the same ``state_dict``;
* ``calculate_clipscore`` / ``_pt`` and ``calculate_lpips`` / ``_pt`` within
  1e-4 relative, with the tiny towers passed as ``model``;
* the nearest resize equal to the JAX package's ``_nearest_torch``,
  including its 224 -> 384 boundary row (dst 108 reads src 62);
* without ``model`` each metric builds its tower on the meta device out of
  the ``state_dict``'s own tensors, and a ``model`` that already holds them
  is not loaded again;
* without weights each metric raises as the JAX package's does;
* the port's ``convert_clip_visual`` / ``convert_siglip_visual`` /
  ``convert_lpips_alex`` on the JAX converters' own test state dicts
  (``tests/test_learned_metrics.py``), in each key form the JAX function
  accepts (bare, ``visual.``, ``visual.trunk.`` / ``trunk.``, lpips'
  ``net.slice*`` or torchvision's ``features.*``, a CLIPA file without
  ``ln_pre``, a (N, C) ``pos_embed``), with keys of other towers beside:
  the tower loads the result with ``strict=True`` and gives the JAX
  tower's output within 1e-4 of its largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.metrics import learned as jlearned
from srbh_tpu.models import clip as jclip
from srbh_tpu.models import lpips as jlpips
from srbh_tpu_torch import convert
from srbh_tpu_torch.metrics import learned
from srbh_tpu_torch.models import clip, lpips
from srbh_tpu_torch.models.layers import init_weights
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
TOWERS = {
    "clip": dict(image_size=32, patch_size=8, width=16, layers=2, heads=2,
                 output_dim=8, use_quick_gelu=True),
    "clipa": dict(image_size=28, patch_size=7, width=16, layers=2, heads=2,
                  output_dim=8, mlp_dim=24, use_quick_gelu=False, ln_pre=False,
                  pool="avg", final_ln_after_pool=True),
    "siglip": dict(image_size=28, patch_size=7, width=16, layers=2, heads=2,
                   mlp_dim=24),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _random(model, seed):
    init_weights(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith("weight") and v.ndim == 1:
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif k.endswith("bias"):
            sd[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
    model.load_state_dict(sd)
    return model.eval()


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _same_state_dict(got, model):
    want = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def _tower(kind, seed=0):
    """(port tower, JAX module, JAX variables, carry)."""
    kw = TOWERS[kind]
    if kind == "siglip":
        model = _random(clip.MAPVisionTransformer(**kw), seed)
        jm = jclip.MAPVisionTransformer(**kw)
        variables = jclip.convert_siglip_visual(_np_sd(model), kw["layers"])
        back = convert.siglip_visual_state_dict(variables, kw["layers"])
    else:
        model = _random(clip.CLIPVisionTransformer(**kw), seed)
        jm = jclip.CLIPVisionTransformer(**kw)
        variables = jclip.convert_clip_visual(_np_sd(model), kw["layers"])
        back = convert.clip_visual_state_dict(variables, kw["layers"])
    return model, jm, variables, back


@pytest.mark.parametrize("kind", ["clip", "clipa", "siglip"])
def test_towers_match_jax(kind):
    model, jm, variables, back = _tower(kind)
    size = TOWERS[kind]["image_size"]
    x = np.random.default_rng(1).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(_nchw(x))
    _close(got.numpy(), want)
    _same_state_dict(back, model)


def _lpips_pair(seed=2):
    model = _random(lpips.LPIPS(), seed)
    sd = _np_sd(model)
    for t in range(5):  # lin heads are non-negative in lpips' weights
        k = f"lin{t}.model.1.weight"
        sd[k] = np.abs(sd[k])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model, jlpips.convert_lpips_alex(sd)


def test_lpips_matches_jax():
    model, variables = _lpips_pair()
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    want = jax.jit(jlpips.LPIPS().apply)(variables, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = model(_nchw(a), _nchw(b))
    taps = model.net(_nchw(a))
    assert [t.shape[1] for t in taps] == list(lpips.ALEX_CHANNELS)
    _close(got.numpy(), want)
    _same_state_dict(convert.lpips_state_dict(variables), model)


def test_clipscore_matches_jax():
    """The single-image form through the CLIP tower, the batched one
    through the SigLIP tower."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (40, 36, 3)).astype(np.float32)
    img2 = np.clip(img + rng.normal(0, 30, img.shape), 0, 255).astype(np.float32)
    model, jm, variables, _ = _tower("clip", seed=4)
    want = jlearned.calculate_clipscore(img, img2, variables, model=jm)
    got = learned.calculate_clipscore(img, img2, model.state_dict(), model=model,
                                      device="cpu")
    assert abs(got - want) <= TOL * abs(want)
    model, jm, variables, _ = _tower("siglip", seed=4)
    imgs = rng.uniform(0, 1, (3, 20, 20, 1)).astype(np.float32)
    imgs2 = rng.uniform(0, 1, (3, 20, 20, 1)).astype(np.float32)
    want = jlearned.calculate_clipscore_pt(imgs, imgs2, variables, model=jm)
    got = learned.calculate_clipscore_pt(_nchw(imgs), _nchw(imgs2),
                                         model.state_dict(), model=model)
    assert abs(got - want) <= TOL * abs(want)


def test_lpips_metrics_match_jax():
    model, variables = _lpips_pair(6)
    sd = model.state_dict()
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (64, 64, 3)).astype(np.float32)
    img2 = np.clip(img + rng.normal(0, 30, img.shape), 0, 255).astype(np.float32)
    want = jlearned.calculate_lpips(img, img2, variables)
    got = learned.calculate_lpips(img, img2, sd, model=model, device="cpu")
    assert abs(got - want) <= TOL * abs(want)
    imgs = rng.uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    imgs2 = rng.uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    want = jlearned.calculate_lpips_pt(imgs, imgs2, variables)
    got = learned.calculate_lpips_pt(_nchw(imgs), _nchw(imgs2), sd, model=model)
    assert abs(got - want) <= TOL * abs(want)


def _shares(model, sd):
    own = model.state_dict()
    return sorted(own) == sorted(sd) and all(
        own[k].data_ptr() == v.data_ptr() for k, v in sd.items())


@pytest.mark.parametrize("kind,preset", [("clip", "clip-ViT-B/16"),
                                         ("clipa", "clipa-ViT-bigG-14"),
                                         ("siglip", "resnet50")])
def test_preset_tower_is_made_of_the_weights(kind, preset, monkeypatch):
    """With no ``model`` the preset (here cut to the tiny width) is built
    on the meta device and takes the ``state_dict``'s tensors: no
    initialisation, no copy; the score is the JAX package's."""
    name = learned._PT_ALIASES.get(preset, preset)
    cls = learned.CLIP_PRESETS[name][0]
    monkeypatch.setitem(learned.CLIP_PRESETS, name, (cls, TOWERS[kind]))
    model, jm, variables, _ = _tower(kind, seed=8)
    sd = model.state_dict()
    assert _shares(learned._clip_tower(None, name, sd, "cpu"), sd)
    rng = np.random.default_rng(9)
    imgs = rng.uniform(0, 1, (2, 24, 24, 3)).astype(np.float32)
    imgs2 = np.clip(imgs + rng.normal(0, 0.1, imgs.shape), 0, 1).astype(np.float32)
    want = jlearned.calculate_clipscore_pt(imgs, imgs2, variables, model=jm)
    got = learned.calculate_clipscore_pt(_nchw(imgs), _nchw(imgs2), sd, preset)
    assert abs(got - want) <= TOL * abs(want)


def test_lpips_is_made_of_the_weights():
    model, variables = _lpips_pair(10)
    sd = model.state_dict()
    assert _shares(learned._lpips(None, sd, "cpu"), sd)
    rng = np.random.default_rng(11)
    imgs = rng.uniform(0, 1, (2, 48, 48, 3)).astype(np.float32)
    imgs2 = rng.uniform(0, 1, (2, 48, 48, 3)).astype(np.float32)
    want = jlearned.calculate_lpips_pt(imgs, imgs2, variables)
    got = learned.calculate_lpips_pt(_nchw(imgs), _nchw(imgs2), sd)
    assert abs(got - want) <= TOL * abs(want)


@pytest.mark.parametrize("kind", ["clip", "lpips"])
def test_model_holding_its_weights_is_not_loaded_again(kind, monkeypatch):
    if kind == "lpips":
        model, other = _lpips_pair(12)[0], _lpips_pair(13)[0]
    else:
        model, other = _tower(kind, seed=12)[0], _tower(kind, seed=13)[0]
    loads = []
    load = model.load_state_dict
    monkeypatch.setattr(model, "load_state_dict",
                        lambda sd: loads.append(sd) or load(sd))
    sd = model.state_dict()
    assert learned._loaded(model, sd, "cpu") is model and loads == []
    assert _shares(model, sd)
    learned._loaded(model, other.state_dict(), "cpu")
    assert len(loads) == 1
    _same_state_dict(other.state_dict(), model)


@pytest.mark.parametrize("src,dst", [(224, 384), (3, 4), (64, 224), (400, 384)])
def test_nearest_resize_is_the_jax_rule(src, dst):
    x = np.arange(src, dtype=np.float32)[None, :, None, None] * np.ones(
        (1, src, src, 1), np.float32)
    want = np.asarray(jlearned._nearest_torch(jnp.asarray(x), dst))
    got = learned._nearest_torch(_nchw(x), dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    if (src, dst) == (224, 384):
        assert got[0, 108, 0, 0] == 62


def test_presets_and_aliases_match_jax():
    assert {k: (v[0].__name__, v[1]) for k, v in learned.CLIP_PRESETS.items()} == {
        k: (v[0].__name__, v[1]) for k, v in jlearned._CLIP_PRESETS.items()}
    assert learned._PT_ALIASES == jlearned._PT_ALIASES


def test_metrics_refuse_without_weights():
    x = np.zeros((8, 8, 3), np.float32)
    t = torch.zeros(1, 3, 8, 8)
    tiny = clip.CLIPVisionTransformer(**TOWERS["clip"])
    for port, jax_fn in (
            (lambda: learned.calculate_clipscore(x, x, model=tiny, device="cpu"),
             lambda: jlearned.calculate_clipscore(x, x)),
            (lambda: learned.calculate_clipscore_pt(t, t, clip_model="resnet50"),
             lambda: jlearned.calculate_clipscore_pt(x[None], x[None],
                                                     clip_model="resnet50")),
            (lambda: learned.calculate_lpips(x, x, device="cpu"),
             lambda: jlearned.calculate_lpips(x, x)),
            (lambda: learned.calculate_lpips_pt(t, t),
             lambda: jlearned.calculate_lpips_pt(x[None], x[None]))):
        for fn in (port, jax_fn):
            with pytest.raises(ValueError, match="needs pretrained weights"):
                fn()
    for fn in (lambda: learned.calculate_clipscore(x, x, clip_model="resnet50"),
               lambda: jlearned.calculate_clipscore(x, x, clip_model="resnet50")):
        with pytest.raises(ValueError, match="is not supported for CLIPScore"):
            fn()


def _published(kind, form):
    """A JAX converter test's state dict in one of the key forms the JAX
    function accepts, with keys of other towers beside it."""
    import test_learned_metrics as jt

    if kind == "lpips":
        sd = jt._torch_lpips_sd(np.random.default_rng(2))
        if form == "torchvision":
            sd = {k.replace(f"net.slice{i + 1}.", "features."): v
                  for i in range(5) for k, v in sd.items()
                  if k.startswith(f"net.slice{i + 1}.")}
        return sd
    if kind == "siglip":
        sd = jt._torch_siglip_sd(np.random.RandomState(7))
        if form == "nc_pos_embed":
            sd["pos_embed"] = sd["pos_embed"][0]
        pre = {"visual.trunk": "visual.trunk.", "trunk": "trunk."}.get(form, "")
        return {**{pre + k: v for k, v in sd.items()},
                "visual.head.weight": np.zeros((4, jt.WIDTH), np.float32)}
    sd = jt._torch_clip_visual_sd(np.random.default_rng(0))
    if kind == "clipa":
        rng = np.random.RandomState(11)
        del sd["ln_pre.weight"], sd["ln_pre.bias"]
        for i in range(jt.LAYERS):
            t = f"transformer.resblocks.{i}."
            sd[t + "mlp.c_fc.weight"] = rng.normal(0, 0.05, (jt.MLP, jt.WIDTH)).astype(np.float32)
            sd[t + "mlp.c_fc.bias"] = rng.normal(0, 0.02, (jt.MLP,)).astype(np.float32)
            sd[t + "mlp.c_proj.weight"] = rng.normal(0, 0.05, (jt.WIDTH, jt.MLP)).astype(np.float32)
    pre = "visual." if form == "visual" else ""
    return {**{pre + k: v for k, v in sd.items()},
            "token_embedding.weight": np.zeros((8, 4), np.float32),
            "logit_scale": np.zeros((), np.float32)}


CONVERT_CASES = [("clip", "bare"), ("clip", "visual"), ("clipa", "visual"),
                 ("siglip", "bare"), ("siglip", "visual.trunk"),
                 ("siglip", "trunk"), ("siglip", "nc_pos_embed"),
                 ("lpips", "lpips")]


@pytest.mark.parametrize("kind,form", CONVERT_CASES)
def test_published_state_dicts_load_like_jax(kind, form):
    import test_learned_metrics as jt

    sd = _published(kind, form)
    tower = dict(image_size=jt.IMG, patch_size=jt.PATCH, width=jt.WIDTH,
                 layers=jt.LAYERS, heads=jt.HEADS)
    if kind == "lpips":
        model, jm = lpips.LPIPS(), jlpips.LPIPS()
        got_sd, variables = lpips.convert_lpips_alex(sd), jlpips.convert_lpips_alex(sd)
    elif kind == "siglip":
        model = clip.MAPVisionTransformer(**tower, mlp_dim=jt.MLP)
        jm = jclip.MAPVisionTransformer(**tower, mlp_dim=jt.MLP)
        got_sd = clip.convert_siglip_visual(sd, jt.LAYERS)
        variables = jclip.convert_siglip_visual(sd, jt.LAYERS)
    else:
        kw = dict(output_dim=32)
        if kind == "clipa":
            kw = dict(output_dim=32, mlp_dim=jt.MLP, use_quick_gelu=False,
                      ln_pre=False, pool="avg", final_ln_after_pool=True)
        model = clip.CLIPVisionTransformer(**tower, **kw)
        jm = jclip.CLIPVisionTransformer(**tower, **kw)
        got_sd = clip.convert_clip_visual(sd, jt.LAYERS)
        variables = jclip.convert_clip_visual(sd, jt.LAYERS)
    model.load_state_dict(got_sd, strict=True)
    model.eval()
    rng = np.random.default_rng(8)
    side = 64 if kind == "lpips" else jt.IMG
    xs = [rng.uniform(0, 1, (2, side, side, 3)).astype(np.float32)
          for _ in range(2 if kind == "lpips" else 1)]
    want = jax.jit(jm.apply)(variables, *map(jnp.asarray, xs))
    with torch.no_grad():
        got = model(*map(_nchw, xs))
    _close(got.numpy(), want)


def test_torchvision_trunk_loads_beside_the_heads():
    """A bare torchvision AlexNet file gives the trunk and no ``lin`` heads,
    as the JAX converter does; its trunk equals the lpips file's."""
    trunk = lpips.convert_lpips_alex(_published("lpips", "torchvision"))
    full = lpips.convert_lpips_alex(_published("lpips", "lpips"))
    heads = {k for k in full if k.startswith("lin")}
    assert sorted(trunk) == sorted(set(full) - heads) and len(heads) == 5
    for k, v in trunk.items():
        assert torch.equal(v, full[k]), k
    missing, unexpected = lpips.LPIPS().load_state_dict(trunk, strict=False)
    assert sorted(missing) == sorted(heads) and unexpected == []
    with pytest.raises(KeyError, match="conv0"):
        lpips.convert_lpips_alex({})
