"""The train-step levers (``lidar_transfer_tpu_torch/probes/train_levers.py``)
and ``models.BF16MomentAdam`` against the JAX package and optax.

``BF16MomentAdam`` takes three steps of the tiny RangeNet (float32
compute) beside ``optax.adam(1e-3, mu_dtype=jnp.bfloat16)`` from the same
flax weights, carried across by ``interop``, on the same batch.
Tolerances: the loss within 1e-5 relative at every step; the parameters
after the three steps within 1e-4 on >= 99.9 % of entries and within 2e-3
on all (an entry whose gradient is at float32 rounding noise takes a full
Adam step of lr = 1e-3 in either direction, as ``test_torch_experiments``
states for the float32 moment; measured: the largest difference 9.6e-6);
the stored bf16 moment within one bf16 ulp of optax's on >= 99.9 % of
entries and within 2e-5 on all (the two sides' gradients differ by the
float32 rounding of the convolutions' sums, and XLA's CPU code contracts
the moment's products into FMAs, so a moment an ulp apart can round to the
neighbouring bf16 value; measured: 99.97 % within one ulp, 99.86 % equal,
the largest difference 7.6e-6 where the moment is 5e-4), the second moment
within 1e-3 relative (measured 1.5e-4). Each of three wrong orders fails
the moment checks: b1 unrounded (69 % within one ulp), the product
``b1' * mu`` rounded to bf16 (87 %), the new moment rounded before this
step's update (94 %). Optax's state carried across by
``interop.adam_state_from_optax`` is bf16 in the port and equal to
optax's bit for bit, and the next step agrees as the first three. The
levers' runner keeps the original's defaults apart from the documented
ones, and remat gives base's loss.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lidar_transfer_tpu.models import rangenet as JR
from lidar_transfer_tpu_torch import interop
from lidar_transfer_tpu_torch.models import rangenet as TR
from lidar_transfer_tpu_torch.probes import train_levers
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_scripts import parser_defaults, script_defaults


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


C = 7


def _batch(rng):
    x = rng.normal(size=(2, 16, 64, 5)).astype(np.float32)
    lab = rng.integers(0, C, (2, 16, 64)).astype(np.int32)
    wt = (rng.random((2, 16, 64)) > 0.2).astype(np.float32)
    jb = dict(features=jnp.asarray(x), labels=jnp.asarray(lab),
              weights=jnp.asarray(wt))
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _bf16_ulp(a):
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return np.exp2(e - 7)


def _moments(opt, model, cfg):
    """The port optimizer's exp_avg and exp_avg_sq, by parameter
    name."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for p, st in opt.state.items():
        out[names[id(p)]] = (st["exp_avg"], st["exp_avg_sq"])
    return out


def test_bf16_moment_adam_matches_optax():
    jcfg = dataclasses.replace(JR.RangeNetConfig.tiny(num_classes=C),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(TR.RangeNetConfig.tiny(num_classes=C),
                               compute_dtype=torch.float32)
    jb, tb = _batch(np.random.default_rng(2))
    jm = JR.RangeNet(jcfg)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 64, 5)))
    tx = optax.adam(1e-3, mu_dtype=jnp.bfloat16)
    opt = tx.init(params)
    tm = TR.RangeNet(tcfg)
    tm.load_state_dict(interop.rangenet_state_dict(jax.device_get(params),
                                                   tcfg))
    topt = TR.BF16MomentAdam(tm.parameters(), lr=1e-3)
    step = jax.jit(lambda p, o, b: JR.train_step_body(jm, tx, p, o, b))
    for _ in range(3):
        params, opt, lj = step(params, opt, jb)
        lt = TR.train_step(tm, topt, tb)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    want = interop.rangenet_state_dict(jax.device_get(params), tcfg)
    diff = np.concatenate([np.abs(v.numpy() - want[k].numpy()).ravel()
                           for k, v in tm.state_dict().items()])
    assert diff.max() <= 2e-3, diff.max()
    assert (diff <= 1e-4).mean() >= 0.999

    st = jax.device_get(opt[0])
    assert int(st.count) == 3
    mu = interop.rangenet_state_dict(st.mu, tcfg)
    nu = interop.rangenet_state_dict(st.nu, tcfg)
    near = total = 0
    for name, (m, v) in _moments(topt, tm, tcfg).items():
        assert m.dtype == torch.bfloat16 and v.dtype == torch.float32
        got, ref = m.float().numpy(), mu[name].numpy()
        assert np.abs(got - ref).max() <= 2e-5, name
        near += int((np.abs(got - ref) <= _bf16_ulp(ref)).sum())
        total += got.size
        np.testing.assert_allclose(v.numpy(), nu[name].numpy(), rtol=1e-3,
                                   atol=1e-12, err_msg=name)
    assert near / total >= 0.999, near / total

    # optax's state carried across: bf16 in the port, value for value
    tm2 = TR.RangeNet(tcfg)
    tm2.load_state_dict(want)
    topt2 = TR.BF16MomentAdam(tm2.parameters(), lr=1e-3)
    topt2.load_state_dict(interop.adam_state_from_optax(
        topt2, tm2, st.mu, st.nu, st.count))
    for name, (m, v) in _moments(topt2, tm2, tcfg).items():
        assert m.dtype == torch.bfloat16
        np.testing.assert_array_equal(m.float().numpy(), mu[name].numpy())
        np.testing.assert_array_equal(v.numpy(), nu[name].numpy())
    assert all(float(s["step"]) == 3.0 for s in topt2.state.values())
    params, opt, lj = step(params, opt, jb)
    np.testing.assert_allclose(float(TR.train_step(tm2, topt2, tb)),
                               float(lj), rtol=1e-5)
    # a float32 moment stays float32 in a torch.optim.Adam
    topt3 = torch.optim.Adam(tm2.parameters(), lr=1e-3)
    sd = interop.adam_state_from_optax(topt3, tm2, st.mu, st.nu, st.count)
    assert sd["state"][0]["exp_avg"].dtype == torch.bfloat16
    topt3.load_state_dict(sd)
    assert topt3.state_dict()["state"][0]["exp_avg"].dtype == torch.float32


def test_make_train_state_mu_bf16():
    """``make_train_state(mu_bf16=True)`` -> a ``BF16MomentAdam`` whose
    moment is bf16 after a step; a checkpoint of it reloads bf16."""
    m = TR.RangeNet(TR.RangeNetConfig.tiny(num_classes=C))
    opt = TR.make_train_state(m, torch.Generator().manual_seed(0),
                              mu_bf16=True)
    assert isinstance(opt, TR.BF16MomentAdam)
    _, tb = _batch(np.random.default_rng(0))
    TR.train_step(m, opt, tb)
    sd = opt.state_dict()
    assert all(s["exp_avg"].dtype == torch.bfloat16
               for s in sd["state"].values())
    opt2 = TR.BF16MomentAdam(m.parameters(), lr=1e-3)
    opt2.load_state_dict(sd)
    for a, b in zip(opt.state.values(), opt2.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert b["exp_avg"].dtype == torch.bfloat16


def test_defaults_match_the_script():
    """Every flag of ``scripts/probe_train_remat.py`` keeps its default,
    apart from ``--cpu`` (``--device``), ``--out`` (no file under
    ``experiments_artifacts/``) and ``--variants``, whose donating
    variants have no counterpart."""
    ref = script_defaults("scripts/probe_train_remat.py")
    got = parser_defaults(train_levers.build_parser())
    for flag in set(ref) - {"--cpu", "--out", "--variants"}:
        assert got[flag] == ref[flag], flag
    assert got["--device"] == "cuda"
    assert got["--variants"] == "base,remat,mu_bf16,remat_mu_bf16"
    left = [v for v in ref["--variants"].split(",")
            if v not in train_levers.VARIANTS]
    assert left == list(train_levers.DONATING)


def test_runner_tiny_cpu_rows_and_remat_loss(tmp_path, monkeypatch, capsys):
    """``--tiny --device cpu`` writes one row a variant with the
    documented keys (device numbers None: not measured); remat's loss is
    base's bit for bit (the same operations, recomputed), and the bf16
    moment's within 1e-3 relative after 3 steps. A donating variant
    or no card exits 2."""
    out = str(tmp_path / "levers.json")
    assert train_levers.main(["--tiny", "--device", "cpu", "--iters", "1",
                              "--out", out]) == 0
    with open(out) as f:
        res = json.load(f)
    assert (res["h"], res["w"], res["iters"], res["device"]) \
        == (16, 64, 1, "cpu")
    rows = {r["variant"]: r for r in res["rows"]}
    assert list(rows) == list(train_levers.VARIANTS)
    for r in rows.values():
        assert tuple(r) == train_levers.ROW_KEYS
        assert r["device_ms"] is r["mfu"] is r["peak_gib"] is None
        assert r["step_ms"] > 0 and r["flops_per_step"] > 0
        assert np.isfinite(r["final_loss"])
    assert rows["remat"]["final_loss"] == rows["base"]["final_loss"]
    assert rows["remat_mu_bf16"]["final_loss"] \
        == rows["mu_bf16"]["final_loss"]
    np.testing.assert_allclose(rows["mu_bf16"]["final_loss"],
                               rows["base"]["final_loss"], rtol=1e-3)
    capsys.readouterr()
    assert train_levers.main(["--variants", "base,all3", "--device",
                              "cpu"]) == 2
    assert "donation" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_levers.main(["--tiny", "--out", out + "2"]) == 2
    assert not os.path.exists(out + "2")
