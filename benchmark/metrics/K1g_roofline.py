"""% of kernel K1g's bound over the traced stretch: the summed
``costs/k1g.py`` bound of every call the stretch's decode steps made (each
layer of each step at its cache index and sliding window) over the summed
time of the K1g kernels; nothing where the traced K1g launches are not
exactly those (one a layer a step: 32 x 59 a Mistral-7B batch)."""

from benchmark.readers import kernel_share, profiled_batches


def read(run):
    cfg, info = run.config, run.info
    B, L = info["batch"], cfg["num_hidden_layers"]
    H, KV, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    Lp = cfg["mapper"]["prefix_length"] + len(cfg["serving"]["tag_ids"])
    steps, W = info["new_tokens"] - 1, cfg["sliding_window"]
    act = 4 if cfg["serving"]["activations"] == "float32" else 2
    bound = run.cost("k1g").bound
    per_batch = L * sum(bound(B, H, KV, d, Lp + i, max(0, Lp + i - W + 1), act)[0]
                        for i in range(steps))
    n = profiled_batches(run)
    return kernel_share(run, "decode_attn_gqa_q8_kernel", n * per_batch, n * L * steps)
