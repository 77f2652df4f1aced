"""PyTorch port, the training slice in bf16 mode against the JAX package's
train step, and gradient checkpointing against none, at tiny width on the
flash route (see tests/test_torch_port_train.py for the set-up).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffute_tpu.train.optim import build_optimizer as j_build_optimizer
from diffute_tpu.train.state import TrainState as JTrainState
from diffute_tpu.train.unet_train import make_unet_train_step
from diffute_tpu.utils import init_pipeline_params as j_init

# pytest puts tests/ itself on sys.path (conftest.py, prepend import mode)
from test_torch_port_train import (
    BATCH,
    TOTAL_STEPS,
    _batch,
    _configs,
    _draws,
    _frozen,
    _param_errs,
    _port_trainer,
)
from port_threads import torch_threads_per_worker  # noqa: F401


@pytest.fixture(scope="module")
def jparams():
    return j_init(_configs()[0], seed=3)


def test_bf16_train_step_matches_jax(jparams):
    """bf16 mode, v-prediction: the two frameworks round at different
    places, so the loss is held to 2e-2 relative (measured 1.1e-3), the grad
    norm to 1e-1 (measured 3.7e-3), and the fp32 master weights, which one
    step moves by about lr = 1e-4 each, to 2.5e-4 at worst (a weight whose
    tiny gradient changes sign moves the other way: measured 2.0e-4) and
    1e-5 on average (measured 1.1e-6)."""
    jcfg, tcfg = _configs(mixed_precision="bf16", prediction_type="v_prediction")
    tx = j_build_optimizer(jcfg.train.optimizer, TOTAL_STEPS, BATCH)
    state = JTrainState.create(jparams["unet"], tx)
    batch, rng = _batch(2, jcfg), jax.random.PRNGKey(7)
    frozen = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                    _frozen(jparams))
    state1, j_metrics = jax.jit(make_unet_train_step(jcfg, tx))(
        state, frozen, batch, rng)
    trainer = _port_trainer(tcfg, jparams)
    metrics = trainer.step(batch, _draws(jcfg, rng, jnp.bfloat16))
    assert trainer.unet.conv_in.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.state.params)
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                               rtol=2e-2)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(j_metrics["grad_norm"]), rtol=1e-1)
    errs = _param_errs(trainer, state1.params)
    assert float(errs.max()) <= 2.5e-4 and float(errs.mean()) <= 1e-5
    # the bf16 compute copy follows the updated masters
    assert torch.equal(trainer.unet.conv_in.weight,
                       trainer.state.params_dict()["conv_in.weight"].bfloat16())


def test_remat_changes_neither_loss_nor_grads(jparams):
    jcfg = _configs()[0]
    batch, draws = _batch(3, jcfg), _draws(jcfg, jax.random.PRNGKey(8))
    out = []
    for remat in (False, True):
        trainer = _port_trainer(_configs(remat=remat)[1], jparams)
        loss = trainer.accumulate_grads(batch, draws)
        out.append((loss, [p.grad.clone() for p in trainer.state.params]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    # and the forward's values are the same with and without grad mode
    x = torch.randn(1, 9, 32, 32)
    ctx = torch.randn(1, 5, trainer.config.unet.cross_attention_dim)
    with torch.no_grad():
        ref = trainer.unet(x, torch.tensor([10]), ctx)
    assert torch.equal(trainer.unet(x, torch.tensor([10]), ctx).detach(), ref)
