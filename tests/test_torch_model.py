"""The port's RangeNet (``lidar_transfer_tpu_torch/models/rangenet.py``)
against the JAX package's flax RangeNet on the same numpy inputs.

The ``tiny`` config runs at float32 compute on both sides, the flax weights
carried across by ``interop.rangenet_state_dict``. Tolerances: logits within
2e-5 absolute (float32 convolutions summed in another order; measured
3e-6), the loss within 1e-5 relative at every Adam step, parameters after
three steps within 1e-4, the cross-entropy within 1e-6 relative, the
features equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_transfer_tpu.models import rangenet as JR
from lidar_transfer_tpu_torch import interop
from lidar_transfer_tpu_torch.models import rangenet as TR
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


C = 7


def _cfgs(**kw):
    j = dataclasses.replace(JR.RangeNetConfig.tiny(num_classes=C),
                            compute_dtype=jnp.float32, **kw)
    t = dataclasses.replace(TR.RangeNetConfig.tiny(num_classes=C),
                            compute_dtype=torch.float32, **kw)
    return j, t


def _jax_params(jcfg, x, rng, jitter=0.1):
    """flax init, every leaf moved by ``jitter`` noise (GroupNorm scales
    and biases off 1 and 0, the head's bias off 0)."""
    p = JR.RangeNet(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(x))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + jitter * rng.normal(
            size=a.shape).astype(np.float32), jax.device_get(p))


def _port(tcfg, params):
    m = TR.RangeNet(tcfg)
    m.load_state_dict(interop.rangenet_state_dict(params, tcfg))
    return m


@pytest.mark.parametrize("W", [256, 250, 13])
def test_logits_match_flax(W):
    """W = 256 needs no pad; 250 and 13 take the edge pad to a multiple
    of 4 and the crop; every stride-(1,2) convolution pads (0, 1)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(W)
    x = rng.normal(size=(2, 16, W, 5)).astype(np.float32)
    params = _jax_params(jcfg, x, rng)
    want = np.asarray(JR.RangeNet(jcfg).apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(tcfg, params)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 16, W, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(
        TR.infer(_port(tcfg, params), torch.from_numpy(x)).numpy(),
        np.asarray(JR.infer(JR.RangeNet(jcfg), params, jnp.asarray(x))))


def test_state_dict_names_and_layout():
    """Every flax leaf lands on one parameter of the port's module; the
    kernels as (out, in, kh, kw)."""
    jcfg, tcfg = _cfgs()
    x = np.zeros((1, 8, 32, 5), np.float32)
    params = jax.device_get(JR.RangeNet(jcfg).init(jax.random.PRNGKey(1),
                                                   jnp.asarray(x)))
    sd = interop.rangenet_state_dict(params, tcfg)
    assert set(sd) == set(TR.RangeNet(tcfg).state_dict())
    np.testing.assert_array_equal(
        sd["blocks.1.conv2.conv.weight"].numpy(),
        params["params"]["ResBlock_1"]["Conv_1"]["kernel"].transpose(
            3, 2, 0, 1))
    np.testing.assert_array_equal(sd["head.bias"].numpy(),
                                  params["params"]["Conv_5"]["bias"])
    np.testing.assert_array_equal(sd["up.1.norm.weight"].numpy(),
                                  params["params"]["GroupNorm_4"]["scale"])
    # the outer "params" is optional
    inner = interop.rangenet_state_dict(params["params"], tcfg)
    assert all(torch.equal(inner[k], v) for k, v in sd.items())


@pytest.mark.parametrize("fault", ["leftover", "shape", "missing"])
def test_state_dict_refuses_what_does_not_fit(fault):
    jcfg, tcfg = _cfgs()
    x = np.zeros((1, 8, 32, 5), np.float32)
    params = jax.device_get(JR.RangeNet(jcfg).init(jax.random.PRNGKey(1),
                                                   jnp.asarray(x)))["params"]
    params = {k: dict(v) for k, v in params.items()}
    if fault == "leftover":
        params["Conv_9"] = {"kernel": np.zeros((1, 1, 2, 2), np.float32)}
    elif fault == "shape":
        params["Conv_0"]["kernel"] = np.zeros((3, 3, 5, 8), np.float32)
    else:
        del params["GroupNorm_2"]["bias"]
    with pytest.raises(ValueError):
        interop.rangenet_state_dict(params, tcfg)


@pytest.mark.parametrize("arch", ["darknet21", "darknet53"])
def test_state_dict_maps_the_published_backbones(arch):
    """The names of darknet21's and darknet53's flax trees (shapes from
    ``jax.eval_shape``, no weights made) all map."""
    jcfg = getattr(JR.RangeNetConfig, arch)(num_classes=20)
    tcfg = getattr(TR.RangeNetConfig, arch)(num_classes=20)
    shapes = jax.eval_shape(JR.RangeNet(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 5)))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = interop.rangenet_state_dict(zeros, tcfg)
    assert len(sd) == len(TR.RangeNet(tcfg).state_dict())


def test_adam_steps_match_optax():
    """Three Adam steps (optax.adam's defaults against torch.optim.Adam's)
    from the same parameters and batch: the losses agree step by step and
    the parameters after them."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 64, 5)).astype(np.float32)
    lab = rng.integers(0, C, (2, 16, 64)).astype(np.int32)
    wt = (rng.random((2, 16, 64)) > 0.2).astype(np.float32)
    jm = JR.RangeNet(jcfg)
    params, opt, tx = JR.make_train_state(jm, jax.random.PRNGKey(3),
                                          (1, 16, 64, 5))
    tm = _port(tcfg, jax.device_get(params))
    topt = torch.optim.Adam(tm.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8)
    jb = dict(features=jnp.asarray(x), labels=jnp.asarray(lab),
              weights=jnp.asarray(wt))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    for _ in range(3):
        params, opt, lj = JR.train_step(jm, tx, params, opt, jb)
        lt = TR.train_step(tm, topt, tb)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    want = interop.rangenet_state_dict(jax.device_get(params), tcfg)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)

    # optax's state carried across continues the same run
    st = jax.device_get(opt[0])
    tm2 = _port(tcfg, jax.device_get(params))
    topt2 = torch.optim.Adam(tm2.parameters(), lr=1e-3)
    topt2.load_state_dict(interop.adam_state_from_optax(
        topt2, tm2, st.mu, st.nu, st.count))
    ref = topt.state_dict()["state"]
    got = topt2.state_dict()["state"]
    for i in ref:
        assert float(got[i]["step"]) == float(ref[i]["step"]) == 3.0
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(
                got[i][key].numpy(), ref[i][key].numpy(), rtol=1e-3,
                atol=1e-7)
    params, opt, lj = JR.train_step(jm, tx, params, opt, jb)
    np.testing.assert_allclose(float(TR.train_step(tm2, topt2, tb)),
                               float(lj), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_cross_entropy_matches(seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(2, 4, 9, C))).astype(np.float32)
    labels = rng.integers(0, C, (2, 4, 9)).astype(np.int32)
    for w in (rng.random((2, 4, 9)).astype(np.float32),
              (rng.random((2, 4, 9)) > 0.5).astype(np.float32),
              np.zeros((2, 4, 9), np.float32)):
        want = float(JR.masked_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w)))
        got = float(TR.masked_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            torch.from_numpy(w)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_range_image_features_match():
    rng = np.random.default_rng(3)
    h, w = 8, 16
    r = rng.uniform(0, 50, (h, w)).astype(np.float32)
    xyz = rng.normal(size=(h, w, 3)).astype(np.float32)
    rem = rng.uniform(-1, 1, (h, w)).astype(np.float32)
    mask = rng.random((h, w)) > 0.3
    want = np.asarray(JR.range_image_features(*map(jnp.asarray,
                                                   (r, xyz, rem, mask))))
    got = TR.range_image_features(*map(torch.from_numpy,
                                       (r, xyz, rem, mask)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_draws_flax_distributions():
    """lecun_normal kernels (|w| <= 2 std, variance 1/fan_in), zero biases,
    GroupNorm 1 and 0; the same generator seed gives the same weights."""
    tcfg = TR.RangeNetConfig.darknet21(num_classes=C)
    m = TR.RangeNet(tcfg)
    TR.make_train_state(m, torch.Generator().manual_seed(4))
    m2 = TR.RangeNet(tcfg)
    TR.make_train_state(m2, torch.Generator().manual_seed(4))
    for (k, v), v2 in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(v, v2), k
        if k.endswith("conv.weight") or k == "head.weight":
            fan_in = v[0].numel()
            std = (1.0 / fan_in) ** 0.5 / .87962566103423978
            assert float(v.abs().max()) <= 2 * std * (1 + 1e-6)
            if v.numel() > 10000:
                np.testing.assert_allclose(float(v.var()), 1.0 / fan_in,
                                           rtol=0.05)
        elif k.endswith("norm.weight"):
            assert torch.all(v == 1)
        else:
            assert torch.all(v == 0), k


def test_remat_keeps_parameters_and_numerics():
    """``remat`` changes neither the parameter names nor the logits nor
    the gradients."""
    _, tcfg = _cfgs()
    rcfg = dataclasses.replace(tcfg, remat=True)
    m, mr = TR.RangeNet(tcfg), TR.RangeNet(rcfg)
    TR.make_train_state(m, torch.Generator().manual_seed(0))
    mr.load_state_dict(m.state_dict())
    assert list(m.state_dict()) == list(mr.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 8, 32, 5)).astype(np.float32))
    lab = torch.zeros((1, 8, 32), dtype=torch.int32)
    w = torch.ones((1, 8, 32))
    grads = []
    for model in (m, mr):
        model.zero_grad()
        TR.masked_cross_entropy(model(x), lab, w).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    with torch.no_grad():
        assert torch.equal(m(x), mr(x))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_bf16_compute_keeps_float32_params_and_logits():
    """The default bf16 compute (``torch.autocast``) leaves the parameters
    float32, returns float32 logits and stays near the float32 forward."""
    tcfg = TR.RangeNetConfig.tiny(num_classes=C)
    m = TR.RangeNet(tcfg)
    TR.make_train_state(m, torch.Generator().manual_seed(0))
    m32 = TR.RangeNet(dataclasses.replace(tcfg,
                                          compute_dtype=torch.float32))
    m32.load_state_dict(m.state_dict())
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 16, 64, 5)).astype(np.float32))
    with torch.no_grad():
        y, y32 = m(x), m32(x)
    assert y.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert float((y - y32).abs().max()) < 0.1 * float(y32.abs().max())
    assert float((y.argmax(-1) == y32.argmax(-1)).float().mean()) > 0.9
