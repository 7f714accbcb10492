"""On the card, at each cell's own size: the program's number stays within
the cell's limit and the control's passes it, on three seeds. The caption
cells' control is the reference at 4 bits where the configuration states 8
(the reference's gap of the token it puts first); the encode cell's, the
reference with every matmul's operands rounded to fp8 (the configuration
serves bf16). Run on the chip:

    python -m pytest benchmark/tests -m cuda -q -p no:cacheprovider
"""

import pytest

from benchmark import harness, readings

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
NUMBER = {"caption": ("gap", "control_gap"), "encode": ("dist", "control_dist")}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_holds(cell, cuda_device):
    w = {c["name"]: c for c in MAN["workloads"]}[cell]
    (limit,) = (c["limit"] for c in harness.load_json("workloads", cell + ".json")["checks"].values())
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        ctx = harness.Ctx(w, seed, cuda_device)
        driver = ctx.mix["driver"]
        out = readings.READINGS[driver](ctx, 1)
        got, control = (out[k] for k in NUMBER[driver])
        assert got <= limit < control, (seed, out)
