"""The port's beam search against the JAX package's.

- ``_beam_select`` on seeded random logits, stopped rows included, at V=50
  (the materialised ``log_softmax`` branch) and V=50257 (GPT-2's vocabulary:
  the affine form, which the JAX package ranks in two stages over groups of
  512 with a ragged last group): sources, tokens and lengths identical,
  the winning averages within 1e-6 of the magnitude of the terms they are
  summed from, ``|avg| + |lse| / new_len`` (both sides subtract the same
  fp32 log-sum-exp, summed in another order; XLA's sum of GPT-2's 50257
  exponentials lies up to ~2e-6 from the float64 sum, and a confident
  row's ``logp`` is much smaller than its ``lse``). Where an index differs
  the two candidates must be a near-tie: their reference values (float64)
  within that tolerance of each other; the cases are counted.
- ``_topk_argmax`` on rows with bitwise-equal maxima returns JAX's order.
- The random tiny GPT-2 of ``tests/test_decoding.py``: tokens and lengths
  identical to JAX ``beam_search_batched``, scores within rtol 1e-5; the
  batched form against the single-clip form.
- The learned tiny captioner (``tests/test_torch_greedy.py``'s fixture):
  float beam tokens identical to JAX's; the int8-cache beam over float and
  w8a8 weights gives JAX ``beam_search_batched_q8``'s captions and the
  float beam's.
- Leaving the loop early: checking for "every beam stopped" every step or
  every ``CHECK_EVERY`` steps gives identical outputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_greedy import _port_gcfg, learned  # noqa: F401  (the fixture)
from zs_aac_tpu.decoding import beam as jbeam
from zs_aac_tpu.models import gpt2 as jg
from zs_aac_tpu.models.gpt2 import quantize_gpt2_int8 as j_quantize
from zs_aac_tpu_torch.decoding import beam as tbeam
from zs_aac_tpu_torch.decoding.greedy import CHECK_EVERY
from zs_aac_tpu_torch.models import gpt2 as tg
from zs_aac_tpu_torch.models.convert import from_jax_params

torch.set_num_threads(2)

SELECT_RTOL = 1e-6
SCORE_RTOL = 1e-5

CFG_J = jg.GPT2Config(vocab_size=50, n_positions=96, n_embd=32, n_layer=2, n_head=4)
CFG_T = tg.GPT2Config(vocab_size=50, n_positions=96, n_embd=32, n_layer=2, n_head=4)
STOP = 7


def _select_inputs(V, seed, B=4, K=3):
    r = np.random.default_rng(seed)
    logits = (r.standard_normal((B * K, V)) * 3).astype(np.float32)
    seq_lengths = r.integers(1, 9, (B, K)).astype(np.float32)
    scores = (-r.random((B, K)) * 2 * seq_lengths).astype(np.float32)
    is_stopped = r.random((B, K)) < 0.3
    is_stopped[0] = True            # a clip whose beams have all stopped
    is_stopped[1] = False
    return logits, scores, seq_lengths, is_stopped


def _reference(logits, scores, seq_lengths, is_stopped, temperature):
    """float64 (scores + logp) / new_len over [B, K, V], stopped rows forced,
    and the selection's tolerance per (b, source beam): SELECT_RTOL times
    |avg| + |lse| / new_len (a stopped row's forced token sums no lse)."""
    B, K = scores.shape
    lg = logits.reshape(B, K, -1).astype(np.float64) / temperature
    lse = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) + lg.max(-1)
    logp = lg - lse[..., None]
    logp[is_stopped] = -1e9
    logp[is_stopped, 0] = 0.0
    new_len = np.where(is_stopped, seq_lengths, seq_lengths + 1).astype(np.float64)
    avg = (scores[..., None] + logp) / new_len[..., None]
    term = np.where(is_stopped, 0.0, np.abs(lse) / new_len)
    return avg, term


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("V", [50, 50257])
def test_beam_select_matches_jax(V, temperature):
    B, K = 4, 3
    near_ties = 0
    for seed in range(3):
        logits, scores, seq_lengths, is_stopped = _select_inputs(V, seed, B, K)
        want = jbeam._beam_select(jnp.asarray(logits), jnp.asarray(scores),
                                  jnp.asarray(seq_lengths), jnp.asarray(is_stopped),
                                  temperature, B, K)
        got = tbeam._beam_select(torch.from_numpy(logits), torch.from_numpy(scores),
                                 torch.from_numpy(seq_lengths), torch.from_numpy(is_stopped),
                                 temperature, B, K)
        w_avg, w_src, w_nxt, w_len = (np.asarray(x) for x in want)
        g_avg, g_src, g_nxt, g_len = (x.numpy() for x in got)
        np.testing.assert_array_equal(g_len, w_len)
        ref, term = _reference(logits, scores, seq_lengths, is_stopped, temperature)
        tol = SELECT_RTOL * (np.abs(w_avg) + np.take_along_axis(term, w_src, axis=1))
        assert (np.abs(g_avg - w_avg) <= tol).all(), (seed, np.abs(g_avg - w_avg) / tol)
        differ = (g_src != w_src) | (g_nxt != w_nxt)
        for b, j in zip(*np.nonzero(differ)):
            a = ref[b, g_src[b, j], g_nxt[b, j]]
            c = ref[b, w_src[b, j], w_nxt[b, j]]
            assert abs(a - c) <= tol[b, j], (seed, b, j, a, c)
            near_ties += 1
        # a clip whose beams all stopped re-selects each beam's token 0, best first
        assert (g_nxt[0] == 0).all()
        np.testing.assert_array_equal(np.sort(g_src[0]), np.arange(K))
    print(f"V={V} t={temperature}: {near_ties} near-ties took another index")
    assert near_ties <= 1


def test_topk_argmax_tie_order_matches_jax():
    r = np.random.default_rng(0)
    x = r.standard_normal((6, 40)).astype(np.float32)
    x[0, [3, 17, 29]] = 5.0                      # three bitwise-equal maxima
    x[1, [0, 39]] = 7.0
    x[2, :] = 1.0                                # all equal
    x[3, [5, 6]] = 4.0
    x[3, [30, 31]] = 3.0                         # two tied pairs
    x[4, [2, 9, 11, 12]] = -0.0                  # equal to +0.0 below
    x[4, 10] = 0.0
    x[4] = np.minimum(x[4], 0.0)
    wv, wi = jbeam._topk_argmax(jnp.asarray(x), 4)
    gv, gi = tbeam._topk_argmax(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    tv, ti = jax.lax.top_k(jnp.asarray(x), 4)   # the decode's first step
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ti))


def _tiny(seed, b):
    params = jg.init_gpt2(jax.random.key(seed), CFG_J)
    r = np.random.default_rng(seed)
    prefix = r.standard_normal((b, 4, CFG_J.n_embd)).astype(np.float32)
    return params, from_jax_params(jax.tree.map(np.asarray, params), device="cpu"), prefix


@pytest.mark.parametrize("seed,beam,steps", [(4, 3, 12), (1, 3, 15), (2, 4, 40), (5, 5, 20)])
def test_beam_batched_identical_to_jax(seed, beam, steps):
    jp, tp, prefix = _tiny(seed, 3)
    wt, wl, ws = jbeam.beam_search_batched(jp, CFG_J, jnp.asarray(prefix), beam, steps, STOP)
    gt, gl, gs = tbeam.beam_search_batched(tp, CFG_T, torch.from_numpy(prefix), beam, steps,
                                           STOP)
    assert tuple(gt.shape) == (3, beam, steps)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=SCORE_RTOL)


def test_beam_batched_matches_single():
    _, tp, prefix = _tiny(4, 3)
    bt, bl, bs = tbeam.beam_search_batched(tp, CFG_T, torch.from_numpy(prefix), 3, 12, STOP)
    for b in range(3):
        st, sl, ss = tbeam.beam_search(tp, CFG_T, torch.from_numpy(prefix[b:b + 1]), 3, 12, STOP)
        for k in range(3):
            L = int(sl[k])
            assert int(bl[b, k]) == L
            assert bt[b, k, :L].tolist() == st[k, :L].tolist(), (b, k)
        np.testing.assert_allclose(bs[b].numpy(), ss.numpy(), rtol=SCORE_RTOL)


def test_beam_q8_over_plain_attention_is_the_kernel_path_on_cpu():
    """On CPU tensors K1's wrapper is its plain version: the default q8 beam
    and the one told to use the plain attention give the same outputs."""
    from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8_plain

    _, tp, prefix = _tiny(3, 2)
    x = torch.from_numpy(prefix)
    a = tbeam.beam_search_batched_q8(tp, CFG_T, x, 3, 10, STOP)
    b = tbeam.beam_search_batched_q8(tp, CFG_T, x, 3, 10, STOP, attention=decode_attn_q8_plain)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, atol=0, rtol=0)


def _best_captions(tok, toks, lens):
    toks, lens = np.asarray(toks), np.asarray(lens)
    return [tok.decode(list(toks[i, 0][: int(lens[i, 0])])).lower()
            for i in range(toks.shape[0])]


def test_beam_tokens_identical_to_jax_on_learned_weights(learned):  # noqa: F811
    tok, ccfg, params, prefixes, emb = learned
    stop = tok.stop_token_id
    wt, wl, ws = jbeam.beam_search_batched(params["gpt2"], ccfg.gpt2, jnp.asarray(emb), 3, 12,
                                           stop)
    tp = from_jax_params(params["gpt2"], device="cpu")
    gt, gl, gs = tbeam.beam_search_batched(tp, _port_gcfg(ccfg), torch.from_numpy(emb), 3, 12,
                                           stop)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=SCORE_RTOL)
    from test_torch_greedy import CAPTIONS

    assert _best_captions(tok, gt, gl) == [CAPTIONS[i % 4] for i in range(12)]


@pytest.mark.parametrize("weights", ["float", "w8a8"])
def test_beam_q8_captions_identical_to_jax(learned, weights):  # noqa: F811
    tok, ccfg, params, prefixes, emb = learned
    stop = tok.stop_token_id
    jp = params["gpt2"]
    tp = from_jax_params(jp, device="cpu")
    if weights == "w8a8":
        jp, tp = j_quantize(jp, "w8a8"), tg.quantize_gpt2_int8(tp, "w8a8")
    wt, wl, _ = jbeam.beam_search_batched_q8(jp, ccfg.gpt2, jnp.asarray(emb), 3, 12, stop)
    gt, gl, _ = tbeam.beam_search_batched_q8(tp, _port_gcfg(ccfg), torch.from_numpy(emb), 3, 12,
                                             stop)
    want = _best_captions(tok, wt, wl)
    assert _best_captions(tok, gt, gl) == want
    ft, fl, _ = tbeam.beam_search_batched(from_jax_params(params["gpt2"], device="cpu"),
                                          _port_gcfg(ccfg), torch.from_numpy(emb), 3, 12, stop)
    assert _best_captions(tok, ft, fl) == want


@pytest.mark.parametrize("q8", [False, True], ids=["float", "q8"])
def test_early_exit_every_check_interval_gives_the_same_outputs(learned, monkeypatch, q8):  # noqa: F811
    """Every beam of every clip stops well before ``entry_length``: the loop
    checked every step leaves at the step after the last stop, the loop
    checked every ``CHECK_EVERY`` steps runs up to ``CHECK_EVERY - 1`` more
    steps over stopped beams; tokens, lengths and scores are identical."""
    tok, ccfg, params, prefixes, emb = learned
    tp = from_jax_params(params["gpt2"], device="cpu")
    decode = tbeam.beam_search_batched_q8 if q8 else tbeam.beam_search_batched
    entry_length = 40

    def run():
        steps = []
        real_step = tg.gpt2_step_q8 if q8 else tg.gpt2_step
        name = "gpt2_step_q8" if q8 else "gpt2_step"

        def counted(*a, **k):
            steps.append(a[4])
            return real_step(*a, **k)

        with monkeypatch.context() as m:
            m.setattr(tbeam, name, counted)
            out = decode(tp, _port_gcfg(ccfg), torch.from_numpy(emb), 3, entry_length,
                         tok.stop_token_id)
        return out, len(steps)

    lazy, lazy_steps = run()
    monkeypatch.setattr(tbeam, "CHECK_EVERY", 1)
    eager, eager_steps = run()
    max_len = int(eager[1].max())
    assert max_len + CHECK_EVERY < entry_length               # all beams stopped early
    assert eager_steps == max_len - 1
    assert lazy_steps == -(-eager_steps // CHECK_EVERY) * CHECK_EVERY > eager_steps
    for u, v in zip(lazy, eager):
        torch.testing.assert_close(u, v, atol=0, rtol=0)



@pytest.mark.parametrize("q8", [False, True], ids=["float", "q8"])
def test_reorder_beam_cache_copies_source_rows_over_valid_positions(q8):
    cfg = tg.GPT2Config(vocab_size=50, n_positions=32, n_embd=16, n_layer=2, n_head=2)
    B, K, T, n = 2, 3, 9, 5
    make = (lambda: tg.init_kv_cache_q8(cfg, B, T, device="cpu")) if q8 else \
        (lambda: tg.init_kv_cache(cfg, B, T, device="cpu"))
    g = torch.Generator().manual_seed(0)
    cache = {k: torch.randint(-100, 100, v.shape, generator=g).to(v.dtype)
             for k, v in make().items()}
    before = {k: v.clone() for k, v in cache.items()}
    expanded = tg.expand_beam_cache(before, K)
    for k, v in expanded.items():
        assert v.shape[1] == B * K
        for r in range(B * K):
            assert torch.equal(v[:, r], before[k][:, r // K])
    src = torch.tensor([[2, 2, 0], [1, 0, 1]])
    start = {k: v.clone() for k, v in expanded.items()}
    tg.reorder_beam_cache(expanded, src, n)
    for k, v in expanded.items():
        for b in range(B):
            for j in range(K):
                r, s = b * K + j, b * K + int(src[b, j])
                assert torch.equal(v[:, r, :, :n], start[k][:, s, :, :n]), (k, b, j)
                assert torch.equal(v[:, r, :, n:], start[k][:, r, :, n:]), (k, b, j)
