"""% of kernel K1's bound over the traced stretch: the summed
``costs/k1.py`` bound of every call the stretch's decode steps made (each
layer of each step at its cache index) over the summed time of the K1
kernels; nothing where the traced K1 launches are not exactly those."""

from benchmark.readers import kernel_share, profiled_batches


def read(run):
    cfg, info = run.config, run.info
    B, H, L = info["batch"], cfg["n_head"], cfg["n_layer"]
    d = cfg["n_embd"] // H
    Lp, N = cfg["mapper"]["prefix_length"], info["new_tokens"]
    act = 4 if cfg["serving"]["activations"] == "float32" else 2
    bound = run.cost("k1").bound
    per_batch = L * sum(bound(B, H, d, Lp + i, act)[0] for i in range(N))
    n = profiled_batches(run)
    return kernel_share(run, "decode_attn_q8_kernel", n * per_batch, n * L * N)
