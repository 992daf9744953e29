"""The port's probes against the JAX probe scripts (CPU).

Each script under ``scripts/`` is loaded as it is
(``importlib.util.spec_from_file_location``) and its Pallas body runs in
interpret mode, in a ``pl.pallas_call`` built here at X, Y, Z = 4, 16, 128
with BX = 2, on the same numpy inputs as the port's plain version. The
probes' kernels run on the card only; ``chip_smoke.py`` holds them against
these plain versions there.

Tolerance: labels equal on >= 1 - 1e-3 of voxels (an ulp of sqrt or a
division may move a voxel across a row or the band's edge), bf16 outputs
within one bf16 ulp of the JAX value where the labels agree, the writes
exactly.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lidar_transfer_tpu.ops import tsdf as JTS
from lidar_transfer_tpu.ops import tsdf_pallas as JTP
from lidar_transfer_tpu_torch import _build
from lidar_transfer_tpu_torch.probes import __main__ as probes_main
from lidar_transfer_tpu_torch.probes import ablate, parts, runs, write
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X, Y, Z, BX = 4, 16, 128, 2
BY = Y
H, CW = 64, 64
LABELS = 1 - 1e-3


def _load(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _specs(col_block=(BX, CW, BY)):
    state = pl.BlockSpec((BX, BY, Z), lambda x, y: (x, y, 0),
                         memory_space=pltpu.VMEM)
    col = pl.BlockSpec(col_block, lambda x, y: (x, 0, y),
                       memory_space=pltpu.VMEM)
    smem = pl.BlockSpec((2, 8), lambda x, y: (0, 0),
                        memory_space=pltpu.SMEM)
    return state, col, smem


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


def _assert_state_close(j, t):
    """(tsdf, label, rem) or a prefix of it: labels on >= LABELS of voxels,
    bf16 fields within one ulp where the labels agree."""
    j = [_f32(a) for a in j]
    t = [a.float().numpy() for a in t]
    same = (np.ones(j[0].shape, bool) if len(j) == 1
            else j[1] == t[1])
    assert same.mean() >= LABELS, same.mean()
    for i in range(0, len(j), 2):
        d = np.abs(t[i] - j[i])[same]
        assert (d <= _bf16_ulp(j[i][same])).all(), (i, d.max())


# ---------------------------------------------------------------- parts
@pytest.fixture(scope="module")
def parts_mod():
    return _load("probe_kernel_parts")


@pytest.fixture(scope="module")
def parts_inputs():
    """The script's params and random columns, placed where a share of the
    voxels lies in FOV and in the band (the script's own placement,
    -25.6 m off, leaves every voxel 35 m behind its random 0-1 m depths);
    labels 0..19 in the packed column."""
    rng = np.random.default_rng(0)
    params = np.zeros((2, 8), np.float32)
    params[0, :5] = (3.0, -0.4, -1.6, 0.05, -0.44)
    dcol = (rng.random((X, CW, Y)) * 5).astype(np.float32)
    lrcol = (rng.random((X, CW, Y)) * 16384 * 20).astype(np.float32)
    return params, dcol, lrcol


@pytest.mark.parametrize("n_out", [1, 3])
@pytest.mark.parametrize("variant", parts.VARIANTS)
def test_parts_plain_matches_make_kernel(parts_mod, parts_inputs, variant,
                                         n_out):
    """parts_plain == the script's make_kernel body (interpret mode) for
    every variant, with one and three outputs."""
    params, dcol, lrcol = parts_inputs
    state, col, smem = _specs()
    dtypes = [jnp.bfloat16, jnp.int16, jnp.bfloat16][:n_out]
    kernel = parts_mod.make_kernel(variant, Y, Z, H, CW, BY, BX, 0.05, 0.25,
                                   n_out)
    j = pl.pallas_call(
        kernel, grid=(X // BX, Y // BY), in_specs=[smem, col, col],
        out_specs=(state,) * n_out,
        out_shape=tuple(jax.ShapeDtypeStruct((X, Y, Z), dt)
                        for dt in dtypes),
        interpret=True)(jnp.asarray(params), jnp.asarray(dcol),
                        jnp.asarray(lrcol))
    t = parts.probe_parts(variant, *(torch.from_numpy(a) for a in
                                     parts_inputs), Z=Z, n_out=n_out, BX=BX)
    assert [a.dtype for a in t] == list(parts.OUT_DTYPES[:n_out])
    _assert_state_close(j, t)
    if variant == "full" and n_out == 3:
        upd = _f32(j[0]) < 1
        assert 0.001 < upd.mean() < 0.5
        assert len(np.unique(_f32(j[1])[upd])) > 5


def test_parts_make_inputs_are_the_scripts():
    """make_inputs gives the script's params and seed-0 columns."""
    params, dcol, lrcol = parts.make_inputs((4, 8, 16))
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(dcol.numpy(),
                                  rng.random((4, 64, 8)).astype(np.float32))
    np.testing.assert_array_equal(
        lrcol.numpy(), (rng.random((4, 64, 8)) * 16384).astype(np.float32))
    ref = jnp.zeros((2, 8), jnp.float32).at[0, 3].set(0.05).at[0, 4].set(
        -0.44).at[0, 0].set(-25.6).at[0, 1].set(-25.6).at[0, 2].set(-6.4)
    np.testing.assert_array_equal(params.numpy(), np.asarray(ref))


# --------------------------------------------------------------- ablate
ABL_ORIGIN = (14.0, -0.4, -5.8)


@pytest.fixture(scope="module")
def ablate_mod():
    mod = _load("probe_integrate_ablate")
    # the script's module globals at this test's size
    mod.X, mod.Y, mod.Z, mod.BY, mod.BX = X, Y, Z, BY, BX
    return mod


@pytest.fixture(scope="module")
def ablate_inputs():
    """Random 64x2048 images with depths around the volume (13-17 m), labels
    0..19 (label 0 takes the same-class branch), remissions; the Pallas
    geometry table of the placement."""
    rng = np.random.default_rng(0)
    depth = (rng.random((H, 2048)) * 4 + 13).astype(np.float32)
    label = rng.integers(0, 20, (H, 2048)).astype(np.int32)
    rem = rng.random((H, 2048)).astype(np.float32)
    spec = JTS.VolumeSpec(origin=ABL_ORIGIN, voxel_size=0.05, dims=(X, Y, Z))
    geom = JTP.precompute_geometry(spec, 3.0, -25.0, H, interpret=True)
    timgs = tuple(torch.from_numpy(a) for a in (depth, label, rem))
    dcol, lrcol = ablate.build_cols(*timgs, (X, Y, Z), ABL_ORIGIN)
    params = ablate.ablate_params(ABL_ORIGIN, (X, Y, Z))
    v_tab = torch.from_numpy(np.array(geom))
    return dict(spec=spec, geom=geom, images=(depth, label, rem),
                args=(params, dcol, lrcol, v_tab))


def test_build_cols_matches_script(ablate_mod, ablate_inputs):
    """build_cols == the script's build_cols (its globals at this size)."""
    depth, label, rem = ablate_inputs["images"]
    j = ablate_mod.build_cols(jnp.asarray(depth), jnp.asarray(label),
                              jnp.asarray(rem),
                              jnp.asarray(ABL_ORIGIN, jnp.float32), 0.05)
    _, dcol, lrcol, _ = ablate_inputs["args"]
    assert dcol.shape == lrcol.shape == (X, CW, Y)
    np.testing.assert_array_equal(dcol.numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(lrcol.numpy(), np.asarray(j[1]))


def test_ablate_nodiv_matches_script(ablate_mod, ablate_inputs):
    """ablate_plain(div=False) == nodiv_kernel, run with the script's own
    (BX, CW, BY) column spec (its kernel_call takes tsdf_pallas._specs,
    whose lane-minor column blocks no longer fit these columns)."""
    params, dcol, lrcol, v_tab = ablate_inputs["args"]
    state, col, smem = _specs()
    anyspace = pl.BlockSpec(memory_space=pl.ANY)
    jstate = ablate_inputs["spec"].init_state_compact()
    j = pl.pallas_call(
        functools.partial(ablate_mod.nodiv_kernel, trunc=0.25),
        grid=(X // BX, Y // BY),
        in_specs=[smem, col, col, state, *([anyspace] * 4)],
        out_specs=(state,) * 3,
        out_shape=tuple(jax.ShapeDtypeStruct((X, Y, Z), dt) for dt in
                        (jnp.bfloat16, jnp.int16, jnp.bfloat16)),
        interpret=True)(jnp.asarray(params.numpy()),
                        jnp.asarray(dcol.numpy()),
                        jnp.asarray(lrcol.numpy()), ablate_inputs["geom"],
                        *jstate)
    t = ablate.probe_ablate(False, params, dcol, lrcol, v_tab, BX=BX)
    _assert_state_close(j, t)
    assert 0.01 < (_f32(j[0]) < 1).mean() < 0.9


def test_ablate_div_matches_integrate_pallas(ablate_inputs):
    """ablate_plain(div=True) (the Pallas body's reset arithmetic on the
    probe's columns) == integrate_pallas(reset, geometry table, no weight
    write) on a compact state, which builds its own columns."""
    spec, geom = ablate_inputs["spec"], ablate_inputs["geom"]
    j = JTP.integrate_pallas(
        spec.init_state_compact(), spec,
        *(jnp.asarray(a) for a in ablate_inputs["images"]),
        fov_up_deg=3.0, fov_down_deg=-25.0, reset=True, geom=geom,
        write_weight=False, interpret=True)
    t = ablate.ablate_plain(True, *ablate_inputs["args"])
    _assert_state_close((j.tsdf, j.label, j.rem), t)
    same_class = (_f32(j.label) == 0) & (_f32(j.tsdf) < 1)
    assert same_class.any() and (_f32(j.label) > 0).any()


def test_ablate_div_and_nodiv_agree(ablate_inputs):
    """With obs_weight 1 the two bodies compute the same state."""
    a = ablate.ablate_plain(True, *ablate_inputs["args"])
    b = ablate.ablate_plain(False, *ablate_inputs["args"])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- write
@pytest.fixture(scope="module")
def write_mod():
    return _load("probe_pallas_write")


@pytest.mark.parametrize("bx,by,dtype,n_out", [
    (2, 16, "bfloat16", 1), (2, 8, "bfloat16", 3), (1, 16, "float32", 1),
    (4, 16, "int32", 1), (2, 16, "int8", 1)])
def test_write_matches_make_write_kernel(write_mod, bx, by, dtype, n_out):
    """probe_write (plain on the CPU) == make_write_kernel over (BX, BY, Z)
    blocks, by dtype and output count."""
    spec = pl.BlockSpec((bx, by, Z), lambda x, y: (x, y, 0),
                        memory_space=pltpu.VMEM)
    j = pl.pallas_call(
        write_mod.make_write_kernel(n_out), grid=(X // bx, Y // by),
        in_specs=[], out_specs=(spec,) * n_out,
        out_shape=tuple(jax.ShapeDtypeStruct((X, Y, Z), getattr(jnp, dtype))
                        for _ in range(n_out)), interpret=True)()
    t = write.probe_write([torch.empty((X, Y, Z), dtype=getattr(torch, dtype))
                           for _ in range(n_out)], BX=bx, BY=by)
    for a, b in zip(j, t, strict=True):
        np.testing.assert_array_equal(b.float().numpy(), _f32(a))


@pytest.mark.parametrize("br", [16, 32])
def test_write_rows_match_probe2d(br):
    """Flat rows of BR (probe2d's (X*Y, Z) layout) write what the 3-D
    blocks write."""
    spec = pl.BlockSpec((br, Z), lambda r: (r, 0), memory_space=pltpu.VMEM)
    j = pl.pallas_call(
        _load("probe_pallas_write").make_write_kernel(1),
        grid=(X * Y // br,), in_specs=[], out_specs=(spec,),
        out_shape=(jax.ShapeDtypeStruct((X * Y, Z), jnp.bfloat16),),
        interpret=True)()
    (t,) = write.probe_write([torch.empty((X, Y, Z), dtype=torch.bfloat16)],
                             BR=br)
    np.testing.assert_array_equal(t.float().numpy().reshape(X * Y, Z),
                                  _f32(j[0]))


@pytest.fixture(scope="module")
def alias_mod():
    mod = _load("probe_alias")
    mod.X, mod.Y, mod.Z, mod.BX, mod.BY = X, Y, Z, BX, BY
    return mod


@pytest.mark.parametrize("mode", write.ALIAS_MODES)
def test_alias_modes_match_probe_alias(alias_mod, mode):
    """alias_call(mode) (plain on the CPU) returns what probe_alias's
    pallas_call returns in that mode: the three constants, and for
    alias_any4 the fourth tensor beside them."""
    state_spec, _, smem = _specs()
    anyspace = pl.BlockSpec(memory_space=pl.ANY)
    n_in, in_specs = {"noalias": (0, []), "alias_any": (3, [anyspace] * 3),
                      "alias_any4": (4, [anyspace] * 4),
                      "alias_vmem": (3, [state_spec] * 3)}[mode]
    dts = [jnp.bfloat16, jnp.int16, jnp.bfloat16]
    jstate = tuple(jnp.full((X, Y, Z), 7, dt)
                   for dt in (dts + [jnp.bfloat16])[:max(n_in, 3)])
    out = pl.pallas_call(
        functools.partial(alias_mod.kernel, n_in=n_in),
        grid=(X // BX, Y // BY), in_specs=[smem] + in_specs,
        out_specs=(state_spec,) * 3,
        out_shape=tuple(jax.ShapeDtypeStruct((X, Y, Z), dt) for dt in dts),
        input_output_aliases={1 + i: i for i in range(3)} if n_in else {},
        interpret=True)(jnp.zeros((2, 8), jnp.float32), *jstate[:n_in])
    j = tuple(out) + tuple(jstate[3:]) if n_in == 4 else tuple(out)
    tstate = [torch.full((X, Y, Z), 7, dtype=dt) for dt in
              write.ALIAS_DTYPES + (torch.bfloat16,)]
    t = write.alias_call(mode, tstate, BX=BX, BY=BY)
    assert len(t) == len(j)
    assert [b.dtype for b in t] == [torch.bfloat16, torch.int16,
                                    torch.bfloat16, torch.bfloat16][:len(t)]
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.float().numpy(), _f32(a))
    if mode != "noalias":
        assert t[0] is tstate[0]                   # written in place


# ------------------------------------------------------- the partitions
#: every block shape and row count ``probes/write.py`` runs at its DIMS, by
#: byte widths: its write rows, its alias rows, and odd sizes whose runs
#: end inside a tile
WRITE_CASES = (
    [(write.DIMS, (2,), dict(BX=bx, BY=by)) for bx, by in (
        (1, 1024), (2, 1024), (4, 1024), (8, 1024), (8, 512), (16, 256),
        (1, 512), (4, 512))]
    + [(write.DIMS, (w,), dict(BX=4, BY=1024)) for w in (4, 1)]
    + [(write.DIMS, (2, 2, 2), dict(BX=bx, BY=1024)) for bx in (4, 2)]
    + [(write.DIMS, (2,), dict(BR=br)) for br in (1024, 4096, 8192)]
    + [((6, 10, 208), (2, 4, 1), dict(BX=3, BY=5)),
       ((7, 9, 1040), (1,), dict(BX=7, BY=3)),
       ((4, 16, 128), (2, 2, 2), dict(BR=16)),
       ((64, 256, 256), (4,), dict(BX=8, BY=64))])


@pytest.mark.parametrize("shape,widths,block", WRITE_CASES)
def test_write_plan_covers_every_byte_once(shape, widths, block):
    """write_plan's tiles, one CTA each, mapped as the kernel maps them,
    cover each output's bytes exactly once."""
    plan = write.write_plan(shape, widths, **block)
    assert plan.grid == plan.tiles
    out, start, end = write.plan_tiles(plan, widths)
    assert len(out) == plan.tiles and (end > start).all()
    nbytes = shape[0] * shape[1] * shape[2]
    for i, w in enumerate(widths):
        order = np.argsort(start[out == i])
        s, e = start[out == i][order], end[out == i][order]
        assert s[0] == 0 and e[-1] == nbytes * w
        np.testing.assert_array_equal(s[1:], e[:-1])  # no gap, no overlap
        assert (s % 16 == 0).all() and (e % 16 == 0).all()


def test_write_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="divide"):
        write.write_plan((4, 16, 128), (2,), BX=3, BY=16)
    with pytest.raises(ValueError, match="BR"):
        write.write_plan((4, 16, 128), (2,), BR=5)
    with pytest.raises(ValueError, match="16 bytes"):
        write.write_plan((4, 16, 3), (2,), BX=1, BY=1)
    assert write.write_plan((4, 16, 128), (2,), BX=1,
                            BY=16).grid == 4      # one tile a run
    with pytest.raises(ValueError, match="2\\^31"):
        write.write_plan((1 << 16, 1 << 16, 1 << 12), (4,), BR=1)


def _ablate_cover(plan, dims):
    n = dims[0] * dims[1] * dims[2]
    got = {"folded": [], "stored": [], "rows": []}
    for _, folded, stored, rows in runs.run_walk(plan, *dims):
        got["folded"].append(folded)
        got["stored"].append(stored)
        got["rows"].append(rows)
    counts = {}
    for k, parts_ in got.items():
        idx = np.concatenate(parts_)
        assert idx.min() >= 0, k
        counts[k] = np.bincount(idx, minlength=n)
    return counts, n


@pytest.mark.parametrize("dims", [(5, 7, 206), (5, 7, 250), (4, 6, 206),
                                  (3, 5, 256), (5, 7, 204), (2, 4, 13),
                                  (1, 3, 40)])
@pytest.mark.parametrize("bx", [1, 2, 4])
@pytest.mark.parametrize("table_align", [16, 4, 1])
def test_ablate_plan_covers_every_voxel_once(dims, bx, table_align):
    """ablate_plan, walked as the kernel walks it (runs of COLS columns,
    warp w of G on runs w, w + G, ..., chunks of 32 * vec voxels, the
    (column, z) carry): every voxel folded, stored and its table row loaded
    exactly once; 4 or 1 voxels a lane where a last run ends inside a wider
    vector or the table is off its alignment."""
    X, Y, Z = dims
    plan = ablate.ablate_plan(X, Y, Z, bx, table_align)
    whole = [v for v in runs.VECS
             if Z % v == 0 or (X * Y) % runs.COLS == 0]
    assert plan.vec == max(v for v in whole if table_align % v == 0)
    assert plan.runs == -(-X * Y // runs.COLS)
    assert (plan.grid - 1) * runs.WARPS * bx < plan.runs \
        <= plan.grid * runs.WARPS * bx
    counts, n = _ablate_cover(plan, dims)
    for k, c in counts.items():
        assert c.shape == (n,) and (c == 1).all(), k


def test_ablate_plan_fallback_is_needed():
    """Forced to 8 voxels a lane where the last run ends inside a vector,
    the walk stores past the volume: what the fallback is for. Outputs off
    their 16-byte alignment take 4 voxels a lane."""
    dims = (5, 7, 206)
    plan = ablate.ablate_plan(*dims, 2)
    assert plan.vec == 1
    counts, n = _ablate_cover(plan._replace(vec=8), dims)
    assert len(counts["stored"]) > n and (counts["folded"] == 1).all()
    assert ablate.ablate_plan(4, 6, 256, out_align=8).vec == 4
    assert [runs.align_of(p) for p in (0x1000, 0x1008, 0x1004, 0x1001)] \
        == [16, 8, 4, 1]
    with pytest.raises(ValueError, match="BX"):
        ablate.ablate_plan(*dims, 0)


@pytest.mark.parametrize("dims", [(5, 7, 206), (5, 7, 250), (3, 5, 256),
                                  (5, 7, 204), (2, 4, 13), (1, 3, 40),
                                  (4, 6, 128)])
@pytest.mark.parametrize("bx", [1, 2, 4, 8])
@pytest.mark.parametrize("out_align", [16, 8, 2])
def test_parts_plan_covers_every_voxel_once(dims, bx, out_align):
    """parts_plan, walked as the parts kernel walks it (runs of COLS
    columns dealt to the warps in turn, BX of them a warp, chunks of
    32 * vec voxels, the (column, z) carry): every voxel folded and stored
    exactly once, for an X*Y that COLS does not divide, a Z that 8 does
    not divide and BX 1 to 8; 4 or 1 voxels a lane where a last run ends
    inside a wider vector or the outputs are off their alignment."""
    X, Y, Z = dims
    plan = parts.parts_plan(X, Y, Z, bx, out_align)
    whole = [v for v in runs.VECS
             if Z % v == 0 or (X * Y) % runs.COLS == 0]
    assert plan.vec == max(v for v in whole if out_align % (2 * v) == 0)
    assert plan == ablate.ablate_plan(X, Y, Z, bx, 16, out_align)
    counts, n = _ablate_cover(plan, dims)
    for k in ("folded", "stored"):
        assert counts[k].shape == (n,) and (counts[k] == 1).all(), k


def test_parts_plan_odd_sizes_take_narrow_vectors():
    """The reference size takes 8 voxels a lane; an X*Y that COLS does not
    divide with Z = 206 takes one, with Z = 204 four; BX need not divide
    X; BX < 1 raises."""
    assert parts.parts_plan(*parts.DIMS, 2).vec == 8
    assert parts.parts_plan(5, 7, 206, 2).vec == 1
    assert parts.parts_plan(5, 7, 204, 2).vec == 4
    plan = parts.parts_plan(1024, 1024, 256, 3)
    assert plan.grid * runs.WARPS * 3 >= plan.runs == 1024 * 1024 // 8
    with pytest.raises(ValueError, match="BX"):
        parts.parts_plan(4, 4, 8, 0)


def test_ablate_any_bx_on_the_cpu(ablate_inputs):
    """BX no longer needs to divide X: the plain version ignores it."""
    a = ablate.probe_ablate(True, *ablate_inputs["args"], BX=3)
    b = ablate.ablate_plain(True, *ablate_inputs["args"])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cpu_warmup_steadies_the_first_sqrt():
    """After the warm-up (this module's fixture) the test cloud's two
    spherical_angles calls agree bit for bit."""
    from lidar_transfer_tpu_torch.probes import first_sqrt

    r = first_sqrt.one(warm=True)
    assert r["differ"] == 0 and r["points"] == 24576


# ------------------------------------------------------------- the rules
def test_probe_wrappers_launch_nothing_on_the_cpu(parts_inputs,
                                                  ablate_inputs):
    """CPU tensors take the plain versions: the probe launch counts stay 0;
    the entry point refuses to run without a card."""
    _build.reset_launch_counts()
    tin = tuple(torch.from_numpy(a) for a in parts_inputs)
    parts.probe_parts("full", *tin, Z=Z)
    ablate.probe_ablate(True, *ablate_inputs["args"])
    write.probe_write([torch.empty((X, Y, Z))], BX=1, BY=Y)
    counts = _build.launch_counts()
    assert {k: counts[k] for k in ("probe_parts", "probe_ablate",
                                   "probe_write")} == dict.fromkeys(
        ("probe_parts", "probe_ablate", "probe_write"), 0)
    if not torch.cuda.is_available():
        assert probes_main.main(["parts"]) == 1


def test_probe_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device raises."""
    meta = torch.device("meta")
    p = torch.zeros((2, 8), device=meta)
    c = torch.zeros((X, CW, Y), device=meta)
    with pytest.raises(ValueError):
        parts.probe_parts("full", p, c, c, Z=Z)
    with pytest.raises(ValueError):
        ablate.probe_ablate(True, p, c, c,
                            torch.zeros((X, Y, Z), dtype=torch.int8,
                                        device=meta))
    with pytest.raises(ValueError):
        write.probe_write([torch.zeros((X, Y, Z), device=meta)], BX=1, BY=Y)
    with pytest.raises(ValueError, match="variant"):
        parts.parts_plain("nowrite", *(torch.zeros(1),) * 3, Z=Z)
