"""% of the int8 GEMMs' bound: over the traced stretch, the sum of each
``aten::_int_mm`` call's bound (``costs/int8_gemm.py`` from the call's
recorded shapes) over the summed time of the kernels it launched."""


def read(run):
    if run.trace is None:
        return None
    bound = run.cost("int8_gemm").bound
    kernels = run.trace.kernels_under("aten::_int_mm")
    if not kernels:
        return None
    ops = {id(k.op): k.op for k in kernels}
    total = 0.0
    for op in ops.values():
        (M, K), (_, N) = op.shapes[0], op.shapes[1]
        total += bound(M, K, N)
    busy = sum(k.end - k.start for k in kernels) * 1e-9
    return 100.0 * total / busy
