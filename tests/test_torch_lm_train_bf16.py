"""The LM zoo's training path in bf16, the configs' dtype, for each of the
ten architectures at ``smoke()`` width: the port's loss against the JAX
package's (jitted on the CPU) from the same bf16 weights and batch, within
5e-2 of the reference loss (XLA fuses and rounds bf16 chains at other
points than torch; see ``test_torch_lm_bf16.py``); every gradient finite;
and the reference's own two-step check on the port (the same batch twice:
the second loss below the first + 0.05).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm_archs import ARCH_NAMES, flat
from test_torch_lm_train import (configs, jax_batch, make_batch, ref_params,
                                 torch_batch)

from repro.models import zoo as jzoo
from repro.models.common import NO_SHARDING
from repro_torch.models import convert
from repro_torch.models import zoo
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw

B, S = 2, 16
BF16_REL = 5e-2
TWO_STEP_RISE = 0.05


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_bf16_train_step(name):
    jcfg, tcfg = configs(name, jnp.bfloat16, torch.bfloat16)
    jp = ref_params(jcfg)
    nb = make_batch(jcfg, B, S)
    jl = float(jax.jit(lambda p, b: jzoo.loss_fn(p, jcfg, NO_SHARDING, b))(
        jp, jax_batch(nb)))
    params = convert.params_from_numpy(tcfg, flat(jp), "cpu")
    assert params.embed.dtype == torch.bfloat16
    tb = torch_batch(nb)
    tl, grads = zoo.loss_and_grads(params, tcfg, tb)
    assert abs(float(tl) - jl) <= BF16_REL * abs(jl), (float(tl), jl)
    for g in tree_leaves(grads):
        assert torch.isfinite(g.float()).all()
    step = zoo.make_train_step(tcfg)
    state = zoo.TrainState(params, adamw.init(params))
    state, m1 = step(state, tb)
    state, m2 = step(state, tb)
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["loss"]))
    assert float(m2["loss"]) < float(m1["loss"]) + TWO_STEP_RISE
    for p in tree_leaves(state.params):
        assert torch.isfinite(p.float()).all()
