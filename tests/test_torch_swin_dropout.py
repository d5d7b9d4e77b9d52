"""SwinV2 dropout (MODEL.DROP_RATE and ``attn_drop_rate``) in the port, on
the CPU.

- At rate 0 in training, and in eval at any rate, the port's outputs equal
  the JAX model's on the same variables (deterministic there), within 1e-4
  (absolute and relative: fp32, other summation orders), on the plain and
  on the kernel path (the plain K1/K3 versions on the CPU against the
  Pallas kernels in interpret mode).
- In training every dropout site JAX has is taken — the patch embedding,
  each block's MLP after GELU and after fc2, its projection and, with
  ``attn_drop_rate``, its attention probabilities — and nowhere else; over
  all sites the dropped fraction is within 5 binomial standard deviations
  of the rate, and every survivor is exactly x / (1 − p) in x's type.
- The kernel paths are JAX's: ``drop_rate`` > 0 runs the plain MLP and
  keeps the attention kernel; ``attn_drop_rate`` > 0 runs the plain
  attention; rate 0 runs both kernels.
- A checkpointed stage replays its masks: the loss and gradients equal
  the uncheckpointed model's (1e-6), and the generator ends in the same
  state.
- ``train_swin`` trains under ``--opts MODEL.DROP_RATE 0.1`` (it raised
  before).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu_torch.models.convert import jax_variables_to_torch
from jax_reference import no_persistent_compile_cache  # noqa: F401
from test_torch_models import SWIN, TOL, _jax_apply, _random_variables
from test_torch_swin_train import CLI_OPTS

X = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)


def _port(kernels=False, **rates):
    from mvuld_tpu_torch.models.swin_v2 import (SwinTransformerV2,
                                                SwinV2Config)
    return SwinTransformerV2(
        SwinV2Config(**SWIN, drop_path_rate=0.0, **rates),
        use_pallas=kernels, use_pallas_mlp=kernels)


@pytest.mark.parametrize("kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("rates,train", [
    (dict(drop_rate=0.0, attn_drop_rate=0.0), True),
    (dict(drop_rate=0.3, attn_drop_rate=0.2), False),
    (dict(drop_rate=0.3, attn_drop_rate=0.0), False)],
    ids=["rate0_train", "eval_both", "eval_drop"])
def test_swin_dropout_matches_jax(kernels, rates, train):
    from mvuld_tpu.models.swin_v2 import PallasOpts
    from mvuld_tpu.models.swin_v2 import SwinTransformerV2 as JSwin
    from mvuld_tpu.models.swin_v2 import SwinV2Config as JCfg

    jm = JSwin(JCfg(**SWIN, drop_path_rate=0.0, **rates), scan_blocks=True,
               use_pallas=kernels, use_pallas_mlp=kernels,
               pallas_opts=PallasOpts(interpret=True) if kernels else None)
    flat = _random_variables(jm, (jnp.asarray(X),),
                             dict(return_features=True), seed=2)
    ref = _jax_apply(jm, flat, jnp.asarray(X), return_features=True)
    pm = _port(kernels, **rates)
    jax_variables_to_torch(flat, pm)
    with torch.no_grad():
        out = pm(torch.as_tensor(X), train=train,
                 gen=torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def _record_dropout(monkeypatch):
    """Wrap ``swin_v2.dropout``: every call with a generator is recorded as
    (input, output, rate)."""
    from mvuld_tpu_torch.models import swin_v2
    calls = []
    inner = swin_v2.dropout

    def recorded(x, rate, gen):
        y = inner(x, rate, gen)
        if gen is not None and rate > 0:
            calls.append((x.detach(), y.detach(), rate))
        return y
    monkeypatch.setattr(swin_v2, "dropout", recorded)
    return calls


@pytest.mark.parametrize("attn_drop", [0.0, 0.25])
def test_swin_dropout_sites_rate_and_scaling(monkeypatch, attn_drop):
    from mvuld_tpu_torch.models.convert import init_jax_like
    calls = _record_dropout(monkeypatch)
    p = 0.3
    pm = _port(drop_rate=p, attn_drop_rate=attn_drop)
    init_jax_like(pm, torch.Generator().manual_seed(0))
    pm(torch.as_tensor(X), train=True, gen=torch.Generator().manual_seed(3))
    blocks = sum(SWIN["depths"])
    per_block = 3 + (attn_drop > 0)        # fc1, fc2, proj (+ attention)
    assert len(calls) == 1 + per_block * blocks
    assert sorted({r for _, _, r in calls}) == sorted({p, attn_drop} - {0.0})
    for rate in {p, attn_drop} - {0.0}:
        x = torch.cat([a.reshape(-1) for a, _, r in calls if r == rate])
        y = torch.cat([b.reshape(-1) for _, b, r in calls if r == rate])
        live = x != 0
        n = int(live.sum())
        dropped = float(((y == 0) & live).sum()) / n
        assert abs(dropped - rate) <= 5 * np.sqrt(rate * (1 - rate) / n), (
            rate, dropped, n)
        kept = y != 0
        torch.testing.assert_close(y[kept], x[kept] / (1.0 - rate),
                                   atol=0.0, rtol=0.0)
    # eval draws nothing
    calls.clear()
    pm(torch.as_tensor(X), train=False, gen=torch.Generator().manual_seed(3))
    assert not calls


@pytest.mark.parametrize("rates,want", [
    (dict(drop_rate=0.0, attn_drop_rate=0.0), {"attention", "mlp"}),
    (dict(drop_rate=0.1, attn_drop_rate=0.0), {"attention"}),
    (dict(drop_rate=0.0, attn_drop_rate=0.1), {"mlp"}),
    (dict(drop_rate=0.1, attn_drop_rate=0.1), set())],
    ids=["rate0", "drop", "attn_drop", "both"])
def test_swin_dropout_takes_the_kernel_paths_jax_takes(monkeypatch, rates,
                                                       want):
    from mvuld_tpu_torch.models import swin_v2
    from mvuld_tpu_torch.models.convert import init_jax_like
    ran = set()
    for name, tag in (("flat_attention", "attention"),
                      ("window_attention_flat", "attention"),
                      ("mlp_ln", "mlp")):
        fn = getattr(swin_v2, name)
        monkeypatch.setattr(
            swin_v2, name,
            lambda *a, _fn=fn, _tag=tag, **k: ran.add(_tag) or _fn(*a, **k))
    pm = _port(kernels=True, **rates)
    init_jax_like(pm, torch.Generator().manual_seed(0))
    blocks = [b for layer in pm.layers for b in layer.blocks]
    assert all(b.attn.use_pallas == ("attention" in want) for b in blocks)
    assert all(b.use_pallas_mlp == ("mlp" in want) for b in blocks)
    out = pm(torch.as_tensor(X), train=True,
             gen=torch.Generator().manual_seed(1))
    out.sum().backward()
    assert ran == want


def test_swin_dropout_checkpointed_stages_replay_their_masks():
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.swin_v2 import (SwinTransformerV2,
                                                SwinV2Config)
    cfg = SwinV2Config(**SWIN, drop_path_rate=0.2, drop_rate=0.2,
                       attn_drop_rate=0.1)
    base = SwinTransformerV2(cfg)
    init_jax_like(base, torch.Generator().manual_seed(0))
    remat = SwinTransformerV2(cfg, remat_stages=(0, 2))
    remat.load_state_dict(base.state_dict())
    x = torch.as_tensor(X)

    def run(model):
        gen = torch.Generator().manual_seed(7)
        out = model(x, train=True, gen=gen)
        loss = (out * out).sum()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss, grads, gen.get_state()

    l0, g0, s0 = run(base)
    l1, g1, s1 = run(remat)
    torch.testing.assert_close(l1, l0, atol=1e-6, rtol=1e-6)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    assert torch.equal(s0, s1)
    # the masks are live: another seed gives another loss
    gen = torch.Generator().manual_seed(8)
    assert not torch.allclose((base(x, train=True, gen=gen) ** 2).sum(), l0)


def test_swin_config_reads_drop_rate_and_keeps_attn_drop_zero():
    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.models.swin_v2 import SwinV2Config
    from types import SimpleNamespace
    cfg = get_config(SimpleNamespace(cfg=None, output="unused",
                                     opts=["MODEL.DROP_RATE", "0.1"]))
    sc = SwinV2Config.from_cfg(cfg)
    assert sc.drop_rate == 0.1 and sc.attn_drop_rate == 0.0
    assert dataclasses.replace(sc, attn_drop_rate=0.2).attn_drop_rate == 0.2


def test_train_swin_trains_with_drop_rate(tmp_path):
    from mvuld_tpu_torch.train.train_swin import main
    opts = [*CLI_OPTS, "MODEL.DROP_RATE", "0.1", "TRAIN.EPOCHS", "1"]
    res = main(["--synthetic", "24", "--batch-size", "8", "--output",
                str(tmp_path), "--device", "cpu", "--opts", *opts])
    assert len(res["history"]) == 1
    assert np.isfinite(res["best_f1"])
