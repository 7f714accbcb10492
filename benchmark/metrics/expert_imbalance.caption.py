"""How unevenly the router loads the experts: the most-loaded expert's rows
summed over the MoE layer calls (the prefill's and every step's) over what
an even spread would give them, the routed rows over the experts (the
program's counters ``moe.expert_rows_max_sum`` and ``moe.routed_rows``).
1.0 is an even spread; a grouped GEMM waits on its largest group."""


def read(run):
    c = run.counters or {}
    rows, top = c.get("moe.routed_rows"), c.get("moe.expert_rows_max_sum")
    if not rows or top is None:
        return None
    return top / (rows / run.config["n_routed_experts"])
