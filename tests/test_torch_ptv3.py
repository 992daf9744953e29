"""Point Transformer V3 (``models/ptv3``, ``ops/serialize``,
``ops/sparse_conv``) against its plain reference (``reference_ptv3``) and
against encoders and maps written out by brute force here, on the CPU.

The network is the tiny PT-v3m1 (two scales of 16 and 32 channels,
patches of 64) on two scans of a few thousand points, seeded weights and
float32 products. The port and the reference do the same float32
arithmetic in another order (SDPA's math path against a dense softmax,
one gather-GEMM against the same by a search), so they agree to round-off
of float32 through the network's depth: the tolerances below are each
20 to 100 times the gap seen, and the bfloat16 control (the port's own
bfloat16 autocast) misses them. The tests marked
``card`` hold kernels E and F to their plain versions on the card.
"""

import ast
import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from lidar_transfer_tpu_torch import reference_ptv3 as R
from lidar_transfer_tpu_torch.experiments import segmentation as TS
from lidar_transfer_tpu_torch.models import ptv3 as M
from lidar_transfer_tpu_torch.ops import serialize as S
from lidar_transfer_tpu_torch.ops import sparse_conv as SC
from lidar_transfer_tpu_torch.utils import runtime
from torch_suite import shared_cores, time_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(M.PTv3Config.tiny(num_classes=6),
                          compute_dtype=torch.float32)
CFG_DICT = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)
            if f.name != "compute_dtype"}
COUNTS = [1500, 1200]
#: logits: float32 round-off through the network, gap seen 3.6e-7 of a
#: largest logit 0.51 (relative 7e-7)
LOGIT_TOL = 2e-5
#: the loss, relative: the same sums in another order, seen 1e-7
LOSS_TOL = 1e-5
#: the worst leaf's gradient gap over the larger of its and the median
#: leaf's norm (pre-BatchNorm biases have a zero gradient up to
#: round-off, so their own norm is no scale), seen 2.5e-5; the bfloat16
#: control reads 0.12
GRAD_TOL = 5e-4


def _scan(n, seed):
    g = torch.Generator().manual_seed(seed)
    p = torch.randn(n, 3, generator=g) * torch.tensor([3.0, 3.0, 0.5])
    return torch.cat([p, torch.rand(n, 1, generator=g)], 1)


@pytest.fixture(scope="module")
def batch():
    pts = torch.cat([_scan(c, i) for i, c in enumerate(COUNTS)])
    lab = torch.randint(-1, CFG.num_classes, (pts.shape[0],),
                        generator=torch.Generator().manual_seed(3))
    return pts, lab


def _model(cfg=CFG, seed=1):
    model = M.PTv3(cfg)
    model.init_parameters(torch.Generator().manual_seed(seed))
    return model


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


# ----------------------------------------------------------------- codes
def _interleave_py(x, y, z, bits):
    code = 0
    for b in range(bits):
        code |= (((x >> b) & 1) << (3 * b + 2)) | (((y >> b) & 1)
                                                   << (3 * b + 1)) \
            | (((z >> b) & 1) << (3 * b))
    return code


def _hilbert_py(x, y, z, bits):
    """Skilling's AxestoTranspose, point by point in Python integers."""
    X = [x, y, z]
    Q = 1 << (bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            if X[i] & Q:
                X[0] ^= P
            else:
                t = (X[0] ^ X[i]) & P
                X[0] ^= t
                X[i] ^= t
        Q >>= 1
    for i in (1, 2):
        X[i] ^= X[i - 1]
    t, Q = 0, 1 << (bits - 1)
    while Q > 1:
        if X[2] & Q:
            t ^= Q - 1
        Q >>= 1
    return _interleave_py(X[0] ^ t, X[1] ^ t, X[2] ^ t, bits)


@pytest.mark.parametrize("bits", [1, 3, 8, 16])
def test_codes_match_a_bit_by_bit_encoder(bits):
    g = torch.Generator().manual_seed(bits)
    grid = torch.randint(0, 1 << bits, (300, 3), generator=g,
                         dtype=torch.int32)
    cloud = torch.randint(0, 3, (300,), generator=g)
    got = S.encode_plain(grid, cloud, bits)
    for i in range(300):
        x, y, z = (int(v) for v in grid[i])
        hi = int(cloud[i]) << (3 * bits)
        want = [hi | _interleave_py(x, y, z, bits),
                hi | _interleave_py(y, x, z, bits),
                hi | _hilbert_py(x, y, z, bits),
                hi | _hilbert_py(y, x, z, bits)]
        assert got[:, i].tolist() == want, (i, bits)
    assert torch.equal(got, R.codes(grid, cloud, bits))


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("row", [2, 3])
def test_hilbert_steps_to_a_neighbouring_cell(bits, row):
    """Over every cell of the 2^bits cube the Hilbert codes are 0 ..
    8^bits - 1 and consecutive codes are face neighbours."""
    r = torch.arange(1 << bits)
    grid = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        -1, 3)
    code = S.encode_plain(grid, torch.zeros(grid.shape[0], dtype=torch.long),
                          bits)[row]
    order = torch.argsort(code)
    assert torch.equal(code[order], torch.arange(grid.shape[0]))
    steps = (grid[order][1:] - grid[order][:-1]).abs().sum(1)
    assert bool((steps == 1).all())


def test_orders_sort_and_invert():
    g = torch.Generator().manual_seed(4)
    grid = torch.randint(0, 64, (500, 3), generator=g)
    grid = torch.unique(grid, dim=0)
    codes = S.encode_plain(grid, torch.zeros(grid.shape[0],
                                             dtype=torch.long), 6)
    order, inverse = S.orders(codes)
    for r in range(4):
        assert bool((codes[r][order[r]].diff() > 0).all())
        assert torch.equal(order[r][inverse[r]], torch.arange(grid.shape[0]))


def test_encoders_refuse_what_they_cannot_code():
    grid = torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        S.encode_plain(grid, torch.zeros(4, dtype=torch.long), 22)
    with pytest.raises(ValueError):
        S.encode_plain(grid, torch.full((4,), 1 << 10), 18)
    with pytest.raises(ValueError):
        S.encode_plain(grid[:, :2], torch.zeros(4, dtype=torch.long), 4)


# --------------------------------------------------------- neighbour maps
def _brute_map(grid, cloud, k):
    cells = {(int(c), *map(int, g)): i for i, (g, c) in
             enumerate(zip(grid, cloud))}
    r = k // 2
    out = np.full((grid.shape[0], k ** 3), grid.shape[0], np.int64)
    for i, (g, c) in enumerate(zip(grid.tolist(), cloud.tolist())):
        d = 0
        for dx in range(-r, r + 1):
            for dy in range(-r, r + 1):
                for dz in range(-r, r + 1):
                    out[i, d] = cells.get((c, g[0] + dx, g[1] + dy,
                                           g[2] + dz), grid.shape[0])
                    d += 1
    return out


@pytest.mark.parametrize("k", [1, 3, 5])
def test_neighbour_map_matches_brute_force(k):
    g = torch.Generator().manual_seed(k)
    grid = torch.unique(torch.randint(0, 9, (400, 3), generator=g), dim=0)
    cloud = torch.randint(0, 2, (grid.shape[0],), generator=g)
    # one cell a (cloud, cell): keep the first of each
    key = cloud * 1000 + grid[:, 0] * 100 + grid[:, 1] * 10 + grid[:, 2]
    _, first = np.unique(key.numpy(), return_index=True)
    grid, cloud = grid[first].int(), cloud[first]
    got = SC.neighbor_map_plain(grid, cloud, k)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _brute_map(grid, cloud, k))
    assert torch.equal(got.long(), R.neighbor_map(grid, cloud, k))


def test_subm_conv_is_its_sum():
    g = torch.Generator().manual_seed(0)
    grid = torch.tensor([[0, 0, 0], [0, 0, 1], [1, 1, 1], [5, 5, 5]],
                        dtype=torch.int32)
    cloud = torch.zeros(4, dtype=torch.long)
    x = torch.randn(4, 3, generator=g, dtype=torch.float64)
    w = torch.randn(27, 3, 2, generator=g, dtype=torch.float64)
    b = torch.randn(2, generator=g, dtype=torch.float64)
    y = SC.subm_conv(x, SC.neighbor_map(grid, cloud, 3), w, b)
    off = SC.offsets(3).tolist()
    for i in range(4):
        want = b.clone()
        for j in range(4):
            d = (grid[j] - grid[i]).tolist()
            if d in off:
                want += x[j] @ w[off.index(d)]
        assert torch.allclose(y[i], want)


@pytest.mark.parametrize("k", [3, 5])
def test_subm_conv_backward_by_the_mirrored_gather(k):
    """The backward's gather of the output's gradient by the same map
    against autograd through the plain gather and product (float64)."""
    g = torch.Generator().manual_seed(k)
    grid = torch.unique(torch.randint(0, 6, (120, 3), generator=g,
                                      dtype=torch.int32), dim=0)
    cloud = torch.randint(0, 2, (grid.shape[0],), generator=g)
    key = cloud * 1000 + grid[:, 0] * 100 + grid[:, 1] * 10 + grid[:, 2]
    _, first = np.unique(key.numpy(), return_index=True)
    grid, cloud = grid[first], cloud[first]
    nbr = SC.neighbor_map(grid, cloud, k)
    x = torch.randn(grid.shape[0], 3, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(k ** 3, 3, 2, generator=g, dtype=torch.float64,
                    requires_grad=True)
    dy = torch.randn(grid.shape[0], 2, generator=g, dtype=torch.float64)
    got = torch.autograd.grad(SC.subm_conv(x, nbr, w), (x, w), dy)
    rows = torch.cat([x, x.new_zeros(1, 3)])[nbr.long()].reshape(
        grid.shape[0], -1)
    want = torch.autograd.grad(rows @ w.reshape(-1, 2), (x, w), dy)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


# ---------------------------------------------- sampling, pooling, model
@pytest.mark.parametrize("drawn", [False, True])
def test_grid_sample_matches_reference(batch, drawn):
    pts, _ = batch
    pick, grid, cloud, cnt, inv = M.grid_sample(
        pts, COUNTS, CFG.grid_size,
        torch.Generator().manual_seed(5) if drawn else None)
    want = R.grid_sample(pts, COUNTS, CFG.grid_size,
                         torch.Generator().manual_seed(5) if drawn else None)
    assert torch.equal(pick, want[0]) and torch.equal(grid.long(), want[1])
    assert torch.equal(cloud, want[2]) and cnt == want[3]
    assert torch.equal(inv, want[4])
    # one point a cell, every point's cell holds its pick
    cell = torch.floor(pts[:, :3] / CFG.grid_size)
    assert torch.equal(cell[pick][inv] - cell, torch.zeros_like(cell))
    assert len(set(map(tuple, torch.cat([cloud[:, None], grid], 1)
                       .tolist()))) == pick.shape[0]


def test_pool_and_unpool_match_reference(batch):
    pts, _ = batch
    pick, grid, cloud, cnt, _ = M.grid_sample(pts, COUNTS, CFG.grid_size)
    gen = torch.Generator().manual_seed(8)
    sc = M.Scale(0, grid, cloud, cnt)
    sc.serialize(gen, 64)
    nxt = M.pool(sc)
    ref = R._serialize(grid.long(), cloud, cnt,
                       torch.Generator().manual_seed(8), 64)
    assert torch.equal(sc.codes, ref["codes"])
    for o in range(4):
        assert torch.equal(sc.seq[o], ref["seq"][o])
        assert torch.equal(sc.back[o], ref["back"][o])
    uniq, cluster = torch.unique(ref["codes"][0] >> 3, return_inverse=True)
    assert torch.equal(sc.cluster, cluster) and nxt.n == uniq.shape[0]
    assert torch.equal(nxt.grid[cluster], grid >> 1)
    assert nxt.counts == torch.bincount(nxt.cloud, minlength=2).tolist()
    # the modules against the reference's formulas, with the same leaves
    model = _model()
    p = _params(model)
    x = torch.randn(sc.n, 16, generator=torch.Generator().manual_seed(2))
    down = model.enc[1].down(x, sc.cluster, nxt.n)
    f = R._linear(p, "enc.1.down.proj", x, None)
    pooled = torch.full((nxt.n, 32), -torch.inf).scatter_reduce(
        0, cluster[:, None].expand_as(f), f, "amax")
    want = torch.nn.functional.gelu(R._bn(p, "enc.1.down.norm", pooled))
    assert torch.allclose(down, want, atol=1e-5)
    up = model.dec[0].up(down, x, sc.cluster)
    u = "dec.0.up"
    want = torch.nn.functional.gelu(R._bn(p, f"{u}.norm_skip", R._linear(
        p, f"{u}.proj_skip", x, None))) + torch.nn.functional.gelu(R._bn(
            p, f"{u}.norm", R._linear(p, f"{u}.proj", down, None)))[cluster]
    assert torch.allclose(up, want, atol=1e-5)


def test_pool_max_shares_ties_whatever_memory_it_starts_in():
    """Pooling's max hands each tied point of a cluster an equal share of
    the cluster's gradient. With zero weights all three points of each
    cluster tie at 0; the memory the max starts in is freed zeros, which a
    backward that also compares the start with the maxima counts as a
    fourth tie."""
    down = M.Down(8, 32)
    torch.nn.init.zeros_(down.proj.weight)
    torch.nn.init.zeros_(down.proj.bias)
    n, m = 12000, 4000
    cluster = torch.arange(n) % m
    x = torch.randn(n, 8, generator=torch.Generator().manual_seed(3))
    seen = {}

    def keep(name):
        def hook(_, inp, out=None):
            t = inp[0] if out is None else out
            t.retain_grad()
            seen[name] = t
        return hook

    down.proj.register_forward_hook(keep("f"))
    down.norm.register_forward_pre_hook(keep("pooled"))
    for _ in range(3):
        torch.zeros(m, 32)
    out = down(x, cluster, m)
    (out * torch.randn(out.shape, generator=torch.Generator()
                       .manual_seed(4))).sum().backward()
    assert torch.equal(seen["f"].grad, seen["pooled"].grad[cluster] / 3)


def test_parameters_are_the_reference_layout():
    names = [(n, tuple(p.shape)) for n, p in _model().named_parameters()]
    assert names == [(n, s) for n, s, _ in R.leaves(CFG_DICT)]
    base = M.PTv3(M.PTv3Config.base())
    layout = R.leaves({f.name: getattr(base.cfg, f.name)
                       for f in dataclasses.fields(base.cfg)})
    assert [(n, tuple(p.shape)) for n, p in base.named_parameters()] == \
        [(n, s) for n, s, _ in layout]
    assert 45e6 < sum(p.numel() for p in base.parameters()) < 47e6


def _forward(model, pts, seed):
    gen = torch.Generator().manual_seed(seed)
    pick, grid, cloud, cnt, _ = M.grid_sample(pts, COUNTS, CFG.grid_size,
                                              gen)
    return model(pts[pick], grid, cloud, cnt, gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_logits_match_reference(batch, dtype):
    """float32 within LOGIT_TOL; the bfloat16 control misses it."""
    pts, _ = batch
    model = _model(dataclasses.replace(CFG, compute_dtype=dtype))
    got = _forward(model, pts, 7).detach()
    gen = torch.Generator().manual_seed(7)
    pick, grid, cloud, cnt, _ = R.grid_sample(pts, COUNTS, CFG.grid_size,
                                              gen)
    want = R.forward(_params(model), pts[pick], grid, cloud, cnt, CFG_DICT,
                     gen)
    gap = float((got.float() - want).abs().max()) / float(
        want.abs().max())
    if dtype == torch.float32:
        assert gap < LOGIT_TOL, gap
    else:
        assert gap > 10 * LOGIT_TOL, gap


def _readings(dtype, batch, steps=2):
    pts, lab = batch
    model = _model(dataclasses.replace(CFG, compute_dtype=dtype))
    p0 = _params(model)
    opt = M.make_optimizer(model)
    losses, m1 = [], None
    for k in range(steps):
        losses.append(float(M.train_step(
            model, opt, dict(points=pts, labels=lab, counts=COUNTS),
            torch.Generator().manual_seed(20 + k))))
        if k == 0:
            m1 = {n: opt.state[p]["exp_avg"] / 0.1
                  for n, p in model.named_parameters()}
    ref_l, ref_g, ref_p = R.train_steps(
        p0, [(pts, lab, COUNTS)] * steps, CFG_DICT,
        [torch.Generator().manual_seed(20 + k) for k in range(steps)])
    med = float(np.median([float(g.norm()) for g in ref_g.values()]))
    grad = max(float((m1[k] - g).norm()) / max(float(g.norm()), med)
               for k, g in ref_g.items())
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_l))
    moved = [k for k, g in ref_g.items() if float(g.norm()) >= 1e-3 * med]
    change = max(float((dict(model.named_parameters())[k].detach()
                        - ref_p[k]).norm()) / float((ref_p[k] - p0[k])
                                                    .norm()) for k in moved)
    return loss, grad, change


def test_train_steps_match_reference(batch):
    """Two AdamW steps: the losses, the first gradient by leaf (from
    AdamW's first moment), and the parameters' change by leaf (leaves
    whose gradient is round-off left out: Adam turns round-off into a
    full step of its sign)."""
    loss, grad, change = _readings(torch.float32, batch)
    assert loss < LOSS_TOL and grad < GRAD_TOL, (loss, grad)
    # Adam's steps amplify round-off where a gradient element is near 0
    assert change < 0.02, change


def test_bf16_control_misses_the_tolerances(batch):
    loss, grad, change = _readings(torch.bfloat16, batch, steps=1)
    assert loss > LOSS_TOL or grad > 10 * GRAD_TOL, (loss, grad)


def test_lovasz_softmax_matches_reference():
    g = torch.Generator().manual_seed(0)
    probs = torch.softmax(torch.randn(500, 7, generator=g), -1)
    labels = torch.randint(0, 5, (500,), generator=g)
    assert torch.allclose(M.lovasz_softmax(probs, labels),
                          R.lovasz(probs, labels), atol=1e-6)
    # a perfect prediction scores 0
    assert float(M.lovasz_softmax(torch.nn.functional.one_hot(
        labels, 7).float(), labels)) == 0.0


def test_drop_path_rates_are_pointcepts():
    enc, dec = M.PTv3Config.base().drop_paths()
    assert [len(r) for r in enc] == [2, 2, 2, 6, 2]
    assert enc[0][0] == 0.0 and enc[-1][-1] == pytest.approx(0.3)
    assert dec[0] == [pytest.approx(0.3 / 7), 0.0]
    assert dec[-1] == [pytest.approx(0.3), pytest.approx(0.3 * 6 / 7)]
    assert (enc, dec) == R.drop_rates({"enc_depths": (2, 2, 2, 6, 2),
                                       "dec_depths": (2, 2, 2, 2),
                                       "drop_path": 0.3})


def test_spans_and_counters(batch):
    pts, lab = batch
    model = _model()
    opt = M.make_optimizer(model)
    M.reset_stage_counts()
    runtime.RECORDER.clear()
    with runtime.tracing():
        M.train_step(model, opt, dict(points=pts, labels=lab, counts=COUNTS),
                     torch.Generator().manual_seed(1))
    spans = runtime.RECORDER.spans()
    names = {s.name for s in spans}
    assert {"model.step", "ptv3.grid_sample", "ptv3.serialize",
            "ptv3.neighbors", "ptv3.pool", "ptv3.unpool"} <= names
    step = next(s for s in spans if s.name == "model.step")
    assert all(step.start_ns <= s.start_ns <= step.end_ns for s in spans
               if s.name.startswith("ptv3."))
    c = M.stage_counts()
    assert set(c["points"]) == {0, 1}
    for s in (0, 1):
        assert c["padded"][s] == c["patches"][s] * 64
        assert c["points"][s] <= c["padded"][s] < c["points"][s] + 2 * 64
        assert c["scores"][s] == c["padded"][s] * 64
    assert set(c["pairs"]) == {"k5.0", "k3.0", "k3.1"}
    # every point is its own neighbour at the kernel's centre
    assert c["pairs"]["k3.0"] >= c["points"][0]
    M.reset_stage_counts()
    assert M.stage_counts()["points"] == {}


def test_pairs_are_counted_only_after_a_reset(batch, monkeypatch):
    """Counting a map's occupied pairs is a pass over it on the device, so
    a forward does it only once a reset has started the counters."""
    pts, lab = batch
    model = _model()
    opt = M.make_optimizer(model)
    monkeypatch.setattr(M, "_count_pairs", False)
    before = M.stage_counts()
    M.train_step(model, opt, dict(points=pts, labels=lab, counts=COUNTS),
                 torch.Generator().manual_seed(1))
    after = M.stage_counts()
    assert after["pairs"] == before["pairs"]
    assert sum(after["points"].values()) > sum(before["points"].values())
    M.reset_stage_counts()
    assert M._count_pairs


def test_predict_gives_each_point_its_cells_class(batch):
    pts, _ = batch
    model = _model()
    pred = M.predict(model, pts, COUNTS)
    assert pred.shape == (pts.shape[0],) and model.training
    _, _, _, _, inv = M.grid_sample(pts, COUNTS, CFG.grid_size)
    for cell in range(0, int(inv.max()), 97):
        assert pred[inv == cell].unique().numel() == 1


# ------------------------------------------------- reference, the CLI
def test_reference_is_plain_and_the_benchmarks_copy():
    path = os.path.join(REPO, "lidar_transfer_tpu_torch", "reference_ptv3.py")
    assert filecmp.cmp(path, os.path.join(REPO, "benchmark", "reference",
                                          "ptv3.py"), shallow=False)
    tree = ast.parse(open(path).read())
    tops = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert tops <= {"__future__", "contextlib", "torch"}, tops


def test_lt_seg_ptv3_trains_predicts_and_evaluates(synthetic_dataset,
                                                  tmp_path, capsys):
    ckpt, pred = str(tmp_path / "pt.pt"), str(tmp_path / "pred")
    assert TS.main(["train", "-d", synthetic_dataset, "--arch", "ptv3",
                    "--tiny", "--steps", "2", "--batch-size", "2",
                    "--out", ckpt, "--device", "cpu"]) == 0
    model, _, _ = TS.load_checkpoint(ckpt, "cpu")
    assert isinstance(model, M.PTv3) and model.cfg.enc_channels == (16, 32)
    assert TS.main(["infer", "-d", synthetic_dataset, "-m", ckpt, "-p", pred,
                    "--device", "cpu"]) == 0
    out = str(tmp_path / "eval.json")
    assert TS.main(["eval", "-d", synthetic_dataset, "-p", pred, "--json",
                    out, "--device", "cpu"]) == 0
    assert "5 scans" in capsys.readouterr().out
    _, mapper, spec = TS.load_checkpoint(ckpt, "cpu")
    with pytest.raises(ValueError):
        TS.write_predictions(synthetic_dataset, pred, model, mapper, spec,
                             knn=True)
    with pytest.raises(SystemExit):
        TS.main(["train", "-d", synthetic_dataset, "--arch", "ptv3",
                 "--remat", "--device", "cpu"])


def test_ptv3_resume_replays_the_uninterrupted_run(synthetic_dataset,
                                                   tmp_path):
    """A PT-v3m1 run stopped after 2 steps and resumed to 3 ends where the
    run of 3 steps does: the same picks, generators and AdamW state."""
    ckpt = str(tmp_path / "pt.pt")
    kw = dict(batch_size=2, model_cfg=M.PTv3Config.tiny(), seed=3,
              verbose=False, device="cpu")
    whole, _, _ = TS.train_segmentation(synthetic_dataset, steps=3, **kw)
    TS.train_segmentation(synthetic_dataset, steps=2, checkpoint_path=ckpt,
                          checkpoint_every=1, **kw)
    resumed, _, _ = TS.train_segmentation(synthetic_dataset, steps=3,
                                          checkpoint_path=ckpt, resume=True,
                                          **kw)
    a, b = whole.state_dict(), resumed.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("bits", [1, 5, 12, 16])
def test_card_serialize_kernel_equals_plain(card, bits):
    g = torch.Generator().manual_seed(bits)
    grid = torch.randint(0, 1 << bits, (100_000, 3), generator=g,
                         dtype=torch.int32)
    cloud = torch.randint(0, 4, (100_000,), generator=g)
    got = S.encode_cuda(grid.to(card), cloud.to(card), bits)
    assert torch.equal(got.cpu(), S.encode_plain(grid, cloud, bits))


@pytest.mark.card
@pytest.mark.parametrize("k", [3, 5])
def test_card_neighbor_kernel_equals_plain(card, k):
    g = torch.Generator().manual_seed(k)
    grid = torch.unique(torch.randint(0, 200, (200_000, 3), generator=g,
                                      dtype=torch.int32), dim=0)
    cloud = torch.zeros(grid.shape[0], dtype=torch.long)
    got = SC.neighbor_map_cuda(grid.to(card), cloud.to(card), k)
    assert torch.equal(got.cpu(), SC.neighbor_map_plain(grid, cloud, k))
