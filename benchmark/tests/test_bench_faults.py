"""A run with the timed path broken underneath comes out not correct.

Each cell is driven as a run drives it (set-up, one batch of the window,
the check), past the harness's look for a card: once as it is, and once with
its answers altered where they are produced: the caption cells' greedy
decode moves every caption's second token to another id; the encode
cell's encoder hands back each clip's embedding on the row of the clip
after it. On the card, at the cell's own size, the sound run is correct
and the broken one is not, against the cell's own limit. On the CPU, at a
tiny size where the cells' limits mean nothing, the broken run's number is
far above the sound run's.
"""

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny_ctx

MAN = harness.manifest()
DECODES = {"htsat-gpt2": "greedy_decode_q8", "mistral7b-lora": "mistral_greedy_decode"}
CELLS = [w["name"] for w in MAN["workloads"]]


def _break(cell, monkeypatch):
    w = {c["name"]: c for c in MAN["workloads"]}[cell]
    driver = harness.load_json("mixes", w["traffic"] + ".json")["driver"]
    if driver == "caption":
        from zs_aac_tpu_torch.decoding import greedy

        name = DECODES[w["config"]]
        real = getattr(greedy, name)

        def broken(params, cfg, *args, **kwargs):
            toks, lens = real(params, cfg, *args, **kwargs)
            toks[:, 1] = (toks[:, 1] + cfg.vocab_size // 2) % cfg.vocab_size
            return toks, lens

        monkeypatch.setattr(greedy, name, broken)
    else:
        from zs_aac_tpu_torch.train import contrastive

        real = contrastive.make_encode_fns

        def broken(*args, **kwargs):
            enc_a, enc_t = real(*args, **kwargs)
            return (lambda variables, wave: enc_a(variables, wave).roll(1, dims=0)), enc_t

        monkeypatch.setattr(contrastive, "make_encode_fns", broken)


def _run(ctx):
    drv = harness.load_module("drivers", ctx.mix["driver"])
    state = drv.setup(ctx)
    harness.run_window(drv, state, 0.0)
    (check,) = drv.check(state, ctx)
    return check


@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_reads_far_off_on_the_cpu(cell, monkeypatch):
    sound = _run(tiny_ctx(cell, seed=2 ** 31 + 5))
    _break(cell, monkeypatch)
    broken = _run(tiny_ctx(cell, seed=2 ** 31 + 5))
    assert broken["value"] > max(10 * sound["value"], 0.1), (sound, broken)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct_on_the_card(cell, cuda_device, monkeypatch):
    w = {c["name"]: c for c in MAN["workloads"]}[cell]
    seed = 2 ** 31 + 77
    sound = _run(harness.Ctx(w, seed, cuda_device))
    assert sound["value"] <= sound["limit"], sound
    _break(cell, monkeypatch)
    broken = _run(harness.Ctx(w, seed, cuda_device))
    assert broken["value"] > broken["limit"], broken
