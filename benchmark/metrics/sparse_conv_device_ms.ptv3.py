"""Device ms a PT-v3m1 train step spends in the submanifold convolutions'
gathers, forward and backward: ``index_select`` by the int32 neighbour
maps, whose kernels the profiler names with their index type (``int``;
every other gather of the step indexes by int64), attributed by name in
the traced stretch. Their products are GEMMs that share their names with
the linears' and are counted in ``train_mfu.ptv3``."""

from harness.op_names import ms_per_step

NAMES = tuple(f"gather_kernel<{v}, int>" for v in (16, 8, 4, 2, 1)) + tuple(
    f"indexSelect{size}Index<{dtype}, int" for size in ("Large", "Small")
    for dtype in ("c10::BFloat16", "float"))


def read(run):
    return ms_per_step(run, NAMES)
