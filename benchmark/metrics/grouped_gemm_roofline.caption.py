"""% of the bf16 grouped GEMMs' bound: over the traced stretch, the sum of
each ``aten::_grouped_mm`` call's bound (``costs/grouped_gemm.py`` from the
call's recorded shapes: rows [T, K], weights [G, K, N]) over the summed
time of the kernels it launched."""


def read(run):
    if run.trace is None:
        return None
    kernels = run.trace.kernels_under("aten::_grouped_mm")
    if not kernels:
        return None
    bound = run.cost("grouped_gemm").bound
    ops = {id(k.op): k.op for k in kernels}
    total = 0.0
    for op in ops.values():
        (T, K), (G, _, N) = op.shapes[0], op.shapes[1]
        total += bound(T, K, N, G)
    busy = sum(k.end - k.start for k in kernels) * 1e-9
    return 100.0 * total / busy
