"""Full-width parameter shapes of the port's flagship against the JAX
package's: RRDBNet-23 and the EfficientNet-B4 height model. The JAX side
costs shapes only (``jax.eval_shape``); names go through the port's
converters, so a name that the converters and the modules disagree on fails
here too.
"""
import numpy as np

import jax
import jax.numpy as jnp

from srbh_tpu import models as jmodels
from srbh_tpu_torch import convert, entry
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


def _shape_map(state_dict):
    return {k: tuple(v.shape) for k, v in state_dict.items()}


def test_full_width_parameter_shapes_match_jax():
    """RRDBNet-23 and the EfficientNet-B4 height model: the same names
    (through the converters) and shapes; JAX side by ``jax.eval_shape``."""
    sr = jmodels.RRDBNet(num_block=23, num_feat=64, num_grow_ch=32)
    hm = jmodels.SRRegressClsFeature(encoder_name="efficientnet-b4",
                                     super_mid=16, isaggre=True, chans_build=7)
    key = jax.random.PRNGKey(0)
    zeros = lambda tree: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), tree)
    sr_vars = zeros(jax.eval_shape(sr.init, key, jnp.zeros((1, 16, 16, 3))))
    hm_vars = zeros(jax.eval_shape(hm.init, key, jnp.zeros((1, 64, 64, 8)),
                                   jnp.zeros((1, 256, 256, 64))))
    tm, tsr, x = entry.flagship(device="cpu", batch=1)
    assert tuple(x.shape) == (1, 64, 64, 8)
    assert _shape_map(tsr.state_dict()) == _shape_map(
        convert.rrdbnet_state_dict(sr_vars, 23))
    assert _shape_map(tm.state_dict()) == _shape_map(
        convert.height_model_state_dict(hm_vars, "efficientnet-b4", True))
