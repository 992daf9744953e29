"""Kernel D, ``ops/group_norm``: GroupNorm, its affine and leaky ReLU in one
forward, and ``models/rangenet.ConvNorm``'s choice of it.

On the CPU the wrapper is ATen's composition and ``ConvNorm`` takes
ATen's path; the CPU tests hold both to that, bit for bit, and every input
the wrapper refuses. The tests marked ``card`` hold the kernel to the plain
float32 composition on the card and skip without one. This file imports no
JAX, so they run on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_group_norm.py
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from lidar_transfer_tpu_torch import _build
from lidar_transfer_tpu_torch.models import rangenet as TR
from lidar_transfer_tpu_torch.models.rangenet import (GN_EPS, RangeNet,
                                                      RangeNetConfig, infer,
                                                      train_step)
from lidar_transfer_tpu_torch.ops import group_norm as GN
from lidar_transfer_tpu_torch.probes.cases import (check_norm, norm_inputs,
                                                   norm_shapes)
from torch_suite import shared_cores, time_limit  # noqa: F401

#: (N, C, H, W, groups): G = 1; the group size 16 of RangeNet; a group
#: size that is not 16; H x W not a multiple of a vector
CPU_SHAPES = ((1, 16, 4, 8, 1), (2, 32, 3, 5, 2), (1, 64, 8, 16, 4),
              (3, 48, 2, 7, 3))
DTYPES = (torch.bfloat16, torch.float32)


@pytest.fixture(autouse=True)
def _fresh_counts():
    _build.reset_launch_counts()
    TR.reset_graph_counts()
    yield
    _build.reset_launch_counts()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _args(N, C, H, W, dtype, device="cpu", seed=0):
    x, w, b = norm_inputs(C, H, W, device, dtype, seed)
    if N > 1:
        x = torch.cat([x] + [norm_inputs(C, H, W, device, dtype, seed + i)[0]
                             for i in range(1, N)])
    return x, w, b


def _parent_forward(self, x):
    """ConvNorm's forward before kernel D: ATen's GroupNorm everywhere."""
    dt = x.dtype
    if self.stride_w == 2:
        x = F.pad(x, (0, 1))
    return F.leaky_relu(self.norm(self.conv(x)), 0.1).to(dt)


def _model(cfg: RangeNetConfig, device="cpu", seed=0) -> RangeNet:
    model = RangeNet(cfg)
    model.init_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def _features(shape, device, seed=0) -> torch.Tensor:
    """RangeNet's 5 input channels, ranges to 80 m."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.tensor([80.0, 80.0, 80.0, 20.0, 1.0])
    return (torch.rand(shape, generator=g) * scale).to(device)


# --- the CPU: ATen's composition and path ---------------------------------


@pytest.mark.parametrize("autocast", (False, True))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_cpu_wrapper_is_the_composition_bit_for_bit(shape, dtype, autocast):
    N, C, H, W, G = shape
    x, w, b = _args(N, C, H, W, dtype)
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        got = GN.group_norm_leaky_relu(x, G, w, b, GN_EPS)
        want = F.leaky_relu(F.group_norm(x, G, w, b, GN_EPS), 0.1).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert _build.launch_counts()["group_norm"] == 0


@pytest.mark.parametrize("grad", (False, True))
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_convnorm_takes_atens_path(dtype, grad, monkeypatch):
    """RangeNet's logits on the CPU, with and without grad mode, are the
    parent's ConvNorm composition's, bit for bit, and launch nothing."""
    model = _model(dataclasses.replace(RangeNetConfig.tiny(num_classes=5),
                                       compute_dtype=dtype))
    x = _features((1, 8, 30, 5), "cpu", seed=1)
    with torch.set_grad_enabled(grad):
        got = model(x)
        with monkeypatch.context() as m:
            m.setattr(TR.ConvNorm, "forward", _parent_forward)
            want = model(x)
    assert torch.equal(got, want)
    assert _build.launch_counts()["group_norm"] == 0


def test_norm_shapes_are_a_forwards():
    """``probes/cases.norm_shapes`` gives the (C, H, W) each GroupNorm of a
    forward sees, in order: darknet53's 57 at 2 x 64, tiny's at a width
    its stages pad."""
    for cfg, H, W in ((RangeNetConfig.darknet53(26), 2, 64),
                      (RangeNetConfig.tiny(5), 8, 30)):
        model = _model(cfg)
        seen = []
        hooks = [m.conv.register_forward_hook(
            lambda _, a, out: seen.append(tuple(out.shape[1:])))
            for m in model.modules() if isinstance(m, TR.ConvNorm)]
        with torch.no_grad():
            model(_features((1, H, W, 5), "cpu"))
        for h in hooks:
            h.remove()
        assert seen == norm_shapes(cfg, H, W)
    assert len(norm_shapes(RangeNetConfig.darknet53(), 64, 2048)) == 57


@pytest.mark.parametrize("N", (1, 8))
def test_stats_layout_covers_each_group_and_fills_the_card(N):
    """Every element of a group in one chunk, chunks a multiple of the
    vector, none empty, no more chunks than a vector a thread would make;
    at darknet53's shapes the grid is several times the H100's 132 SMs."""
    shapes = set(norm_shapes(RangeNetConfig.darknet53(), 64, 2048))
    shapes |= {(C, H, W) for _, C, H, W, _ in CPU_SHAPES}
    for C, H, W in sorted(shapes):
        for G in {C // 16 or 1, 1}:
            for vec in (8, 4, 1):
                span = C // G * H * W
                if span % vec:
                    continue
                S, chunk = GN.stats_layout(N * G, span, vec)
                assert chunk % vec == 0 and S >= 1
                assert (S - 1) * chunk < span <= S * chunk
                assert S <= -(-span // (GN.THREADS * vec))
                assert N * G * S <= max(GN.STATS_BLOCKS, N * G) + N * G
                if span >= GN.STATS_BLOCKS * GN.THREADS * vec // (N * G):
                    assert N * G * S >= 2 * 132, (C, H, W, G, vec)


def _refusals(device):
    """(what, call, error, message) for each input the wrapper refuses."""
    x, w, b = _args(1, 32, 4, 8, torch.bfloat16, device)
    run = GN.group_norm_leaky_relu_cuda
    return [
        ("non-contiguous", lambda: run(x.transpose(2, 3), 2, w, b, GN_EPS),
         ValueError, "contiguous"),
        ("float16 input", lambda: run(x.half(), 2, w, b, GN_EPS),
         TypeError, "input torch.float16"),
        ("float64 input", lambda: run(x.double(), 2, w, b, GN_EPS),
         TypeError, "input torch.float64"),
        ("C not divisible by G", lambda: run(x, 3, w, b, GN_EPS),
         ValueError, "32 channels in 3 groups"),
        ("no groups", lambda: run(x, 0, w, b, GN_EPS), ValueError,
         "in 0 groups"),
        ("one dimension", lambda: run(x.reshape(-1), 2, w, b, GN_EPS),
         ValueError, "non-empty"),
        ("empty", lambda: run(x[:0], 2, w, b, GN_EPS), ValueError,
         "non-empty"),
        ("float64 weight", lambda: run(x, 2, w.double(), b, GN_EPS),
         ValueError, "weight"),
        ("short bias", lambda: run(x, 2, w, b[:16], GN_EPS),
         ValueError, "bias"),
        ("input requires grad", lambda: run(x.requires_grad_(), 2, w, b,
                                            GN_EPS),
         RuntimeError, "no backward"),
        ("weight requires grad", lambda: run(
            x.detach(), 2, w.clone().requires_grad_(), b, GN_EPS),
         RuntimeError, "no backward"),
    ]


REFUSED = [r[0] for r in _refusals("cpu")]


@pytest.mark.parametrize("what", REFUSED)
def test_cpu_wrapper_refuses(what):
    call, error, message = {r[0]: r[1:] for r in _refusals("cpu")}[what]
    with pytest.raises(error, match=message):
        call()


def test_cpu_tensors_reach_only_the_device_refusal():
    """What passes every other check is refused for its device by the
    kernel's entry; with grad mode off an input that requires grad is no
    refusal; the wrapper itself takes the plain version."""
    x, w, b = _args(1, 32, 4, 8, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        GN.group_norm_leaky_relu_cuda(x, 2, w, b, GN_EPS)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        GN.group_norm_leaky_relu_cuda(x.requires_grad_(), 2, w, b, GN_EPS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        GN.group_norm_leaky_relu(x.detach().to("meta"), 2, w.to("meta"),
                                 b.to("meta"), GN_EPS)
    assert _build.launch_counts()["group_norm"] == 0


# --- on the card ------------------------------------------------------------


def _card_shapes():
    """darknet53's distinct norm shapes at 1x64x2048, one of batch 8, and
    tiny's, with G = 1 and an H x W no vector divides."""
    out = [(1, C, H, W, C // 16) for C, H, W in
           dict.fromkeys(norm_shapes(RangeNetConfig.darknet53(), 64, 2048))]
    out.append((8, 32, 64, 2048, 2))
    out += [(1, C, H, W, C // 16) for C, H, W in
            dict.fromkeys(norm_shapes(RangeNetConfig.tiny(), 8, 64))]
    return out + [(1, 16, 8, 64, 1), (2, 32, 5, 7, 2), (3, 48, 2, 7, 3)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_kernel_against_the_plain_float32_composition(card, dtype):
    """Statistics within 1e-5 relative (the mean against the group's mean
    and deviation), outputs as ``probes/cases.check_norm`` holds them: the
    two sum in other orders in float32."""
    for N, C, H, W, G in _card_shapes():
        what = f"{(N, C, H, W)} G={G} {dtype}"
        x, w, b = _args(N, C, H, W, dtype, card, seed=C + W)
        got, mean, rstd = GN.group_norm_leaky_relu_cuda(x, G, w, b, GN_EPS)
        y32, mean32, rstd32 = torch.native_group_norm(
            x.float(), w, b, N, C, H * W, G, GN_EPS)
        want = F.leaky_relu(y32, 0.1).to(dtype)
        sigma = 1 / rstd32
        assert (mean - mean32).abs().le(
            1e-5 * (mean32.abs() + sigma)).all(), what
        assert (rstd - rstd32).abs().le(1e-5 * rstd32).all(), what
        check_norm(got, want, what)
        assert torch.equal(GN.group_norm_leaky_relu_cuda(
            x, G, w, b, GN_EPS)[0], got), f"{what}: not repeatable"


@pytest.mark.card
@pytest.mark.parametrize("what", REFUSED)
def test_card_wrapper_refuses(card, what):
    call, error, message = {r[0]: r[1:] for r in _refusals(card)}[what]
    with pytest.raises(error, match=message):
        call()
    assert _build.launch_counts()["group_norm"] == 0


@pytest.mark.card
def test_card_grad_mode_launches_none(card):
    """A forward that records gradients, and ``train_step``, run ATen's
    GroupNorm; the same forward without grad mode runs the kernel once a
    norm."""
    model = _model(RangeNetConfig.darknet53(26), card)
    x = _features((2, 64, 256, 5), card)
    model(x).sum().backward()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    train_step(model, opt, dict(
        features=x, labels=torch.zeros((2, 64, 256), dtype=torch.long,
                                       device=card),
        weights=torch.ones((2, 64, 256), device=card)))
    assert _build.launch_counts()["group_norm"] == 0
    with torch.no_grad():
        model(x)
    assert _build.launch_counts()["group_norm"] == 57


@pytest.mark.card
def test_card_infer_agrees_with_atens_forward(card):
    """``infer``'s replay (kernel D) against ``model(x)`` with grad mode on
    (ATen's GroupNorm): the same class on >= 99.85 % of pixels, and each as
    close to the float32 forward (TF32 off, ATen's GroupNorm): the share of
    pixels where the kernel's class is the float32 forward's falls short of
    ATen's by under 0.05 %. Both round the same float32 values to bf16
    after statistics summed in other orders; at darknet53's initial
    weights a pixel's two best logits are often near a tie, and there the
    57 layers' one-ulp differences can pick either (on an H100: 99.87 % of
    pixels agree, and each forward agrees with float32 on 99.686 %)."""
    model = _model(RangeNetConfig.darknet53(26), card)
    m32 = _model(dataclasses.replace(RangeNetConfig.darknet53(26),
                                     compute_dtype=torch.float32), card)
    x = _features((1, 64, 2048, 5), card, seed=3)
    got = infer(model, x).long()
    _build.reset_launch_counts()
    allow_tf32 = torch.backends.cudnn.allow_tf32
    with torch.enable_grad():
        want = torch.argmax(model(x), dim=-1)
        torch.backends.cudnn.allow_tf32 = False
        try:
            exact = torch.argmax(m32(x), dim=-1)
        finally:
            torch.backends.cudnn.allow_tf32 = allow_tf32
    assert _build.launch_counts()["group_norm"] == 0
    share = lambda a, b: float((a == b).float().mean())  # noqa: E731
    assert share(got, want) >= 0.9985
    assert share(got, exact) >= share(want, exact) - 5e-4


@pytest.mark.card
def test_card_one_capture_records_57_launches(card):
    """The capture's warm-up forwards and the captured one each launch the
    kernel once a norm, 57 for darknet53; a replay launches nothing from
    the host."""
    model = _model(RangeNetConfig.darknet53(26), card)
    x = _features((1, 64, 2048, 5), card, seed=4)
    infer(model, x)
    assert TR.graph_counts() == {"captures": 1, "replays": 1}
    assert _build.launch_counts()["group_norm"] == 57 * (TR.WARMUP_CALLS + 1)
    _build.reset_launch_counts()
    infer(model, x)
    assert _build.launch_counts()["group_norm"] == 0
