"""The port's captioner training against the JAX package.

Same flax-initialized weights on both sides (moved across by
``from_jax_params``), same numpy inputs made from a seed. Tolerances (fp32;
the packages differ in summation order only):

- train logits and losses: atol 1e-5;
- gradients: each leaf within 1e-5 of JAX's plus 1e-4 of the leaf's largest
  entry (the tied ``wte`` sums over every position and the vocabulary);
- 3 AdamW steps at noise 0: losses and every parameter within 1e-5 of JAX's,
  GPT-2 bitwise unchanged under ``only_prefix``;
- the noise (which cannot match ``jax.random`` bit for bit) by its
  properties: unit norm out, the input itself at variance 0, the Gaussian
  variance recovered within 10% (``_variance_estimate``), uniform-ball noise
  inside its radius with the ball's mean norm within 2%, one seed one result.

``PYTHONPATH=. python tests/test_torch_caption_train.py --write-fixture``
regenerates ``zs_aac_tpu_torch/testdata/tiny_captioner/train_expected.json``
from the JAX package: ``CAPTION_TRAIN_STEPS`` AdamW steps from the committed
``best.pth`` on ``caption_train_batch()``, ``only_prefix`` off and on.
"""

import json
import math
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zs_aac_tpu.models import caption as jc
from zs_aac_tpu.models.gpt2 import GPT2Config as JGPT2Config
from zs_aac_tpu.train import caption_trainer as jt
from zs_aac_tpu.train.optim import linear_warmup_lr as j_linear_warmup_lr
from zs_aac_tpu_torch import testdata
from zs_aac_tpu_torch.models import caption as tc
from zs_aac_tpu_torch.models.convert import from_jax_params, to_jax_params
from zs_aac_tpu_torch.models.gpt2 import GPT2Config as TGPT2Config
from zs_aac_tpu_torch.train import caption_trainer as tt
from zs_aac_tpu_torch.train.optim import linear_warmup_lr
from zs_aac_tpu_torch.utils import noise as tn

torch.set_num_threads(2)

GPT2 = dict(vocab_size=40, n_positions=48, n_embd=32, n_layer=2, n_head=4)
E, P, S, B = 16, 4, 8, 6


def _cfgs(**kw):
    base = dict(prefix_length=P, prefix_size=E, clip_length=P, num_layers=2, max_seq_len=S)
    base.update(kw)
    return (jc.CaptionConfig(**base, gpt2=JGPT2Config(**GPT2)),
            tc.CaptionConfig(**base, gpt2=TGPT2Config(**GPT2)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(jcfg, seed=0, with_sound_effect=False):
    params = _np(jc.init_caption_model(jax.random.key(seed), jcfg,
                                       with_sound_effect=with_sound_effect))
    return params, from_jax_params(params, device="cpu")


def _batch(seed=1, hard=False, B=B):
    r = np.random.default_rng(seed)
    tokens = r.integers(1, GPT2["vocab_size"], (B, S))
    lens = r.integers(3, S + 1, B)
    lens[0] = S
    mask = np.ones((B, P + S), np.float32)
    for i, n in enumerate(lens):
        tokens[i, n:] = 0
        mask[i, P + n:] = 0.0
    batch = {"tokens": tokens.astype(np.int64), "mask": mask,
             "prefix": r.standard_normal((B, E)).astype(np.float32)}
    if hard:
        H = 5
        hm = np.ones((B, H), np.float32)
        hm[1, 3:] = 0.0
        hm[2, 4:] = 0.0
        hp = r.integers(1, GPT2["vocab_size"], (B, H)) * hm.astype(np.int64)
        batch.update(hard_prompt=hp.astype(np.int64), hard_mask=hm)
    return batch


def _labels(seed=5, n=12):
    return np.random.default_rng(seed).standard_normal((n, E)).astype(np.float32)


def _jax_logits(params, jcfg, batch, labels=None):
    fn = jax.jit(lambda p, b, lab: jc.caption_train_logits(
        p, jcfg, b["tokens"], b["prefix"], b["mask"], b.get("hard_prompt"),
        b.get("hard_mask"), lab))
    return np.asarray(fn(params, batch, labels))


def _port_logits(port, tcfg, batch, labels=None):
    g = lambda k: None if k not in batch else torch.from_numpy(batch[k])
    return tc.caption_train_logits(
        port, tcfg, g("tokens"), g("prefix"), g("mask"), g("hard_prompt"), g("hard_mask"),
        None if labels is None else torch.from_numpy(labels))


LOGIT_CASES = {
    "plain": (dict(), False, False),
    "hard_prompt": (dict(), True, False),
    "only_soft_prompt": (dict(only_soft_prompt=True), True, False),
    "sound_effect": (dict(sound_effect_num=3), True, True),
}


@pytest.mark.parametrize("case", list(LOGIT_CASES))
@pytest.mark.parametrize("mapping_type", ["mlp", "transformer"])
def test_train_logits_and_loss_match_jax(case, mapping_type):
    kw, hard, labels = LOGIT_CASES[case]
    jcfg, tcfg = _cfgs(mapping_type=mapping_type, **kw)
    params, port = _init(jcfg)
    batch = _batch(hard=hard)
    lab = _labels() if labels else None
    want = _jax_logits(params, jcfg, batch, lab)
    with torch.no_grad():
        got = _port_logits(port, tcfg, batch, lab)
    assert got.shape == want.shape == (B, S, GPT2["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    want_loss = float(jc.caption_loss(jnp.asarray(want), jnp.asarray(batch["tokens"])))
    got_loss = float(tc.caption_loss(got, torch.from_numpy(batch["tokens"])))
    assert abs(got_loss - want_loss) <= 1e-5


def test_caption_loss_ignores_padding_like_jax():
    r = np.random.default_rng(7)
    logits = r.standard_normal((4, 6, 30)).astype(np.float32) * 3
    tokens = r.integers(1, 30, (4, 6))
    tokens[1, 2:] = 0
    tokens[2, :] = 0           # a row of padding only
    tokens[3, 5] = 0
    want = float(jc.caption_loss(jnp.asarray(logits), jnp.asarray(tokens)))
    got = float(tc.caption_loss(torch.from_numpy(logits), torch.from_numpy(tokens)))
    assert abs(got - want) <= 1e-5
    all_pad = np.zeros((2, 6), np.int64)
    assert float(tc.caption_loss(torch.from_numpy(logits[:2]), torch.from_numpy(all_pad))) == 0.0


def _flat(tree, prefix=""):
    """Leaves of a parameter tree by path, lists keyed by index."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("mapping_type", ["mlp", "transformer"])
def test_gradients_match_jax(mapping_type):
    jcfg, tcfg = _cfgs(mapping_type=mapping_type)
    params, port = _init(jcfg)
    batch = _batch(hard=True)

    def jloss(p):
        return jc.caption_loss(jnp.asarray(_jax_logits_traced(p, jcfg, batch)),
                               jnp.asarray(batch["tokens"]))

    want = _flat(_np(jax.jit(jax.grad(jloss))(params)))
    tree = tt.tensor_tree(port)
    leaves = _flat_tensors(tree)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = tc.caption_loss(_port_logits(port, tcfg, batch), torch.from_numpy(batch["tokens"]))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    got = _flat(to_jax_params(_unflat_like(port, grads)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        tol = 1e-5 + 1e-4 * np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)


def _jax_logits_traced(p, jcfg, batch):
    g = lambda k: jnp.asarray(batch[k])
    return jc.caption_train_logits(p, jcfg, g("tokens"), g("prefix"), g("mask"),
                                   g("hard_prompt"), g("hard_mask"))


def _flat_tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tensors(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflat_like(port, grads):
    """The port's parameter tree with each parameter replaced by its
    gradient (modules rebuilt so ``to_jax_params`` lays them out)."""
    import copy

    out = {}
    for k, v in port.items():
        if isinstance(v, torch.nn.Module):
            m = copy.deepcopy(v)
            with torch.no_grad():
                for name, p in m.named_parameters():
                    p.copy_(grads[f"{k}/{name}"])
            out[k] = m
        else:
            out[k] = _sub(v, grads, f"{k}/")
    return out


def _sub(tree, grads, prefix):
    if isinstance(tree, dict):
        return {k: _sub(v, grads, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_sub(v, grads, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return grads[prefix[:-1]]


STEPS = 3


def _jax_run(jcfg, params, batches, lr, wd):
    opt = jt.make_caption_optimizer(jcfg, j_linear_warmup_lr(lr, 1, STEPS + 1), wd)
    state = jt.CaptionTrainState(jax.tree.map(jnp.asarray, params),
                                 opt.init(jax.tree.map(jnp.asarray, params)),
                                 jnp.zeros((), jnp.int32))
    step = jt.make_caption_train_step(jcfg, opt, noise_variance=0.0)
    losses = []
    for b in batches:
        state, loss = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(0))
        losses.append(float(loss))
    return losses, _flat(_np(state.params))


def _port_run(tcfg, port, batches, lr, wd):
    opt = tt.make_caption_optimizer(tcfg, linear_warmup_lr(lr, 1, STEPS + 1), wd)
    state = tt.CaptionTrainState(port, opt.init(tt.tensor_tree(port)), 0)
    step = tt.make_caption_train_step(tcfg, opt, noise_variance=0.0, device="cpu")
    losses = []
    for b in batches:
        state, loss = step(state, b, 0)
        losses.append(float(loss))
    return losses, _flat(to_jax_params(state.params))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("only_prefix", [False, True])
@pytest.mark.parametrize("mapping_type", ["mlp", "transformer"])
def test_train_steps_match_jax(mapping_type, only_prefix, weight_decay):
    jcfg, tcfg = _cfgs(mapping_type=mapping_type, only_prefix=only_prefix)
    params, port = _init(jcfg)
    gpt2_before = _flat(to_jax_params(port["gpt2"]))
    batches = [_batch(seed=10 + i, hard=True) for i in range(STEPS)]
    want_losses, want = _jax_run(jcfg, params, batches, 1e-3, weight_decay)
    got_losses, got = _port_run(tcfg, port, batches, 1e-3, weight_decay)
    np.testing.assert_allclose(got_losses, want_losses, atol=1e-5, rtol=0)
    assert sorted(got) == sorted(want)
    moved = 0.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
        moved = max(moved, float(np.abs(want[k] - _flat(params)[k]).max()))
    assert moved > 1e-4   # the steps moved the parameters
    if only_prefix:
        after = _flat(to_jax_params(port["gpt2"]))
        assert all(np.array_equal(after[k], gpt2_before[k]) for k in gpt2_before)


# ---------------------------------------------------------------------------
# noise injection, by its properties
# ---------------------------------------------------------------------------


def _variance_estimate(x, y):
    """The Gaussian variance behind ``y = normalize(normalize(x) + n * std)``:
    the part of y orthogonal to u = normalize(x), over its part along u, is
    n_perp * std / (1 + u.n std); its squared norm averages (E - 1) var
    E[1 / (1 + z)^2], z ~ N(0, var), which is (E - 1) var (1 + 3 var + ...),
    within 5% of (E - 1) var at var <= 0.016."""
    u = x / x.norm(dim=-1, keepdim=True)
    along = (y * u).sum(-1)
    perp = y - along[:, None] * u
    return float(((perp.norm(dim=-1) / along) ** 2).mean() / (x.shape[1] - 1))


def test_noise_properties():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((512, 1024)).astype(np.float32))
    assert tn.noise_injection(x, 0.0, generator=torch.Generator().manual_seed(0)) is x
    for variance in (0.016, 0.001):
        y = tn.noise_injection(x, variance, generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(y.norm(dim=-1), torch.ones(512), atol=1e-5, rtol=0)
        assert abs(_variance_estimate(x, y) / variance - 1) <= 0.10, variance
        again = tn.noise_injection(x, variance, generator=torch.Generator().manual_seed(1))
        assert torch.equal(y, again)
        other = tn.noise_injection(x, variance, generator=torch.Generator().manual_seed(2))
        assert not torch.equal(y, other)
    y = tn.noise_injection(x, 0.016, uniform_noise=True,
                           generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(y.norm(dim=-1), torch.ones(512), atol=1e-5, rtol=0)
    ball = tn.get_uniform_ball_noise((4096, 16), radius=math.sqrt(0.016),
                                     generator=torch.Generator().manual_seed(4))
    norms = ball.norm(dim=-1)
    assert float(norms.max()) <= math.sqrt(0.016) * (1 + 1e-6)
    # uniform in the ball: E|x| = R d / (d + 1)
    assert abs(float(norms.mean()) / (math.sqrt(0.016) * 16 / 17) - 1) <= 0.02
    # dont_norm keeps the input's scale out of the first normalization
    y = tn.noise_injection(x * 3, 0.016, dont_norm=True,
                           generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(y.norm(dim=-1), torch.ones(512), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# sound effects, cross-attention, support memory
# ---------------------------------------------------------------------------


def test_sound_effect_choice_matches_jax():
    r = np.random.default_rng(8)
    prefix = r.standard_normal((7, E)).astype(np.float32)
    labels = _labels(n=30)
    want = np.asarray(jc.sound_effect_choice(jnp.asarray(prefix), jnp.asarray(labels), 4))
    got = tc.sound_effect_choice(torch.from_numpy(prefix), torch.from_numpy(labels), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    got3 = tc.sound_effect_choice(torch.from_numpy(prefix[:, None]), torch.from_numpy(labels), 4)
    np.testing.assert_array_equal(got3.numpy(), want)


@pytest.mark.parametrize("version", [1, 2])
def test_cross_attention_matches_jax(version):
    jcfg, tcfg = _cfgs(sound_effect_num=3)
    params, port = _init(jcfg)
    params["cross_attention"] = _np(jc.init_cross_attention(jax.random.key(9), jcfg))
    port = from_jax_params(params, device="cpu")
    batch, labels = _batch(seed=4), _labels()
    want = np.asarray(jc.cross_attention_prefix(params, jcfg, jnp.asarray(batch["prefix"]),
                                                jnp.asarray(labels), version, train=False))
    lab = torch.from_numpy(labels)
    with torch.no_grad():
        got = tc.cross_attention_prefix(port, tcfg, torch.from_numpy(batch["prefix"]), lab,
                                        version, train=False)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        want_logits = np.asarray(jc.caption_cross_train_logits(
            params, jcfg, jnp.asarray(batch["tokens"]), jnp.asarray(batch["prefix"]),
            jnp.asarray(batch["mask"]), jnp.asarray(labels), version, train=False))
        got_logits = tc.caption_cross_train_logits(
            port, tcfg, torch.from_numpy(batch["tokens"]), torch.from_numpy(batch["prefix"]),
            torch.from_numpy(batch["mask"]), lab, version, train=False)
        np.testing.assert_allclose(got_logits.numpy(), want_logits, atol=1e-5, rtol=0)
    assert sorted(_flat(to_jax_params(port["cross_attention"]))) == \
        sorted(_flat(params["cross_attention"]))


def test_cross_attention_v2_training_masks_leave_one_effect_open(monkeypatch):
    jcfg, tcfg = _cfgs(sound_effect_num=3)
    port = tc.init_caption_model(tcfg, seed=0, device="cpu")
    port["cross_attention"] = tc.init_cross_attention(tcfg, seed=1, device="cpu")
    masks = []
    forward = tc.SoundEffectCrossAttention.forward

    def spy(self, q, kv, key_mask=None):
        masks.append(key_mask)
        return forward(self, q, kv, key_mask)

    monkeypatch.setattr(tc.SoundEffectCrossAttention, "forward", spy)
    prefix = torch.from_numpy(np.random.default_rng(2).standard_normal((2000, E)).astype(np.float32))
    lab = torch.from_numpy(_labels())
    with torch.no_grad():
        out = tc.cross_attention_prefix(port, tcfg, prefix, lab, 2, train=True,
                                        mask_probability=0.8,
                                        generator=torch.Generator().manual_seed(0))
    m = masks[-1]
    assert m.shape == (2000, 1, 3) and m.dtype == torch.bool
    assert int(m.all(dim=-1).sum()) == 0            # no row masks every effect
    assert int((m.sum(dim=-1) == 2).sum()) > 0.2 * 2000   # rows re-opened (0.8^3 of them) or not
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="generator"):
        tc.cross_attention_prefix(port, tcfg, prefix, lab, 2, train=True)


def test_map_to_memory_matches_jax():
    from zs_aac_tpu.utils.memory import construct_support_memory as j_support
    from zs_aac_tpu.utils.memory import map_to_memory as j_map
    from zs_aac_tpu_torch.utils.memory import construct_support_memory, map_to_memory

    r = np.random.default_rng(11)
    records = [{"text_embedding": r.standard_normal((1, E)).astype(np.float32)}
               for _ in range(20)]
    query = r.standard_normal((5, E)).astype(np.float32)
    mem = construct_support_memory(records, device="cpu")
    np.testing.assert_array_equal(mem.numpy(), np.asarray(j_support(records)))
    want = np.asarray(j_map(jnp.asarray(query), jnp.asarray(mem.numpy())))
    got = map_to_memory(torch.from_numpy(query), mem).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# learning, and the committed train record
# ---------------------------------------------------------------------------

CAPTIONS = [
    "a dog barks in the yard.",
    "rain falls on the roof.",
    "a car horn blares loudly.",
    "birds sing in the trees.",
]


def test_caption_training_learns_cluster_captions():
    """The port analogue of ``tests/test_learning.py``: 150 steps on four
    caption clusters bring the loss under a quarter of its first value, and
    the greedy decode of fresh cluster embeddings gives the captions."""
    from zs_aac_tpu_torch.data.tokenizer import WordTokenizer
    from zs_aac_tpu_torch.decoding.greedy import greedy_decode

    tok = WordTokenizer.from_corpus(CAPTIONS)
    cfg = tc.CaptionConfig(prefix_length=4, prefix_size=32, clip_length=4, max_seq_len=12,
                           gpt2=TGPT2Config(vocab_size=tok.vocab_size, n_positions=64,
                                            n_embd=64, n_layer=2, n_head=4))
    steps, Bl = 150, 32
    opt = tt.make_caption_optimizer(cfg, linear_warmup_lr(3e-3, 10, steps))
    state = tt.create_caption_state(0, cfg, opt, device="cpu")
    step = tt.make_caption_train_step(cfg, opt, noise_variance=0.0, device="cpu")

    def cluster(r, k):
        c = np.zeros(32, np.float32)
        c[k * 8:(k + 1) * 8] = 1.0
        return (c + 0.05 * r.standard_normal(32)).astype(np.float32)

    def make_batch(seed):
        r = np.random.default_rng(seed)
        ks = r.integers(0, 4, Bl)
        tokens = np.zeros((Bl, 12), np.int64)
        mask = np.zeros((Bl, 16), np.float32)
        mask[:, :4] = 1.0
        for i, k in enumerate(ks):
            ids = tok.encode(CAPTIONS[k])
            tokens[i, :len(ids)] = ids
            mask[i, 4:4 + len(ids)] = 1.0
        return {"tokens": tokens, "mask": mask,
                "prefix": np.stack([cluster(r, k) for k in ks])}

    losses = []
    for s in range(steps):
        state, loss = step(state, make_batch(s), 1)
        losses.append(float(loss))
    assert losses[-1] < 0.25 * losses[0], (losses[0], losses[-1])
    r = np.random.default_rng(999)
    prefix = torch.from_numpy(np.stack([cluster(r, i % 4) for i in range(12)]))
    with torch.no_grad():
        emb = tc.caption_embeddings(state.params, cfg, prefix)
        toks, lens = greedy_decode(state.params["gpt2"], cfg.gpt2, emb, 12, tok.stop_token_id,
                                   10 ** 9)
    preds = [tok.decode(list(toks[i][: int(lens[i])].numpy())).lower() for i in range(12)]
    assert sum(p == CAPTIONS[i % 4] for i, p in enumerate(preds)) >= 10, preds


# the replay is held to the JAX record within these relative errors
# (``testdata.train_fixture_errors``: losses, and per-leaf checksums relative
# to the leaf's sum of |x| or of x^2), those ``chip_smoke.py`` holds the
# recorded runs to on the card (``TRAIN_FIXTURE_TOL``). On learned weights
# the attention key biases, whose exact gradient is 0, get rounding noise
# that Adam scales up to ~lr: ``h/0/attn/c_attn/b`` is the leaf furthest
# from the record, 1.1e-5 on the CPU.
CAPTION_FIXTURE_TOL = {"loss": 1e-4, "params": 1e-4}


def test_committed_train_record_replays():
    want = json.loads((testdata.FIXTURE_DIR / "train_expected.json").read_text())
    got = testdata.replay_caption_train_fixture(device="cpu")
    assert sorted(got) == sorted(want) == ["full", "only_prefix"]
    for name in want:
        err = testdata.train_fixture_errors(got[name], want[name])
        assert all(err[k] <= CAPTION_FIXTURE_TOL[k] for k in err), (name, err)
    # under only_prefix GPT-2 comes out of the steps as it went in
    start = testdata.checksums(_np_best())
    for k, v in got["only_prefix"]["checksums"].items():
        if k.startswith("gpt2/"):
            assert v == start[k], k


def _np_best():
    from zs_aac_tpu_torch.utils.checkpoints import load_params

    return load_params(str(testdata.FIXTURE_DIR / "best.pth"))


def write_fixture():
    """Record the JAX package's runs into ``tiny_captioner/train_expected.json``."""
    from flax import serialization

    from zs_aac_tpu.utils.checkpoints import load_params

    fields = testdata.caption_fixture_config()
    gpt2 = JGPT2Config(**fields.pop("gpt2"))
    o = testdata.CAPTION_TRAIN_OPTIM
    batch = {k: jnp.asarray(v) for k, v in testdata.caption_train_batch().items()}
    out = {}
    for name, only_prefix in (("full", False), ("only_prefix", True)):
        cfg = jc.CaptionConfig(**fields, only_prefix=only_prefix, gpt2=gpt2)
        shapes = jax.eval_shape(lambda k: jc.init_caption_model(k, cfg), jax.random.key(0))
        params = load_params(str(testdata.FIXTURE_DIR / "best.pth"),
                             jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
        opt = jt.make_caption_optimizer(
            cfg, j_linear_warmup_lr(o["lr"], o["warmup"], testdata.CAPTION_TRAIN_STEPS + 1),
            o["weight_decay"])
        params = jax.tree.map(jnp.asarray, params)
        state = jt.CaptionTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
        step = jt.make_caption_train_step(cfg, opt, noise_variance=0.0)
        losses = []
        for _ in range(testdata.CAPTION_TRAIN_STEPS):
            state, loss = step(state, batch, jax.random.key(0))
            losses.append(float(loss))
        tree = serialization.to_state_dict(_np(state.params))
        out[name] = {"losses": losses, "checksums": testdata.checksums(tree)}
    path = testdata.FIXTURE_DIR / "train_expected.json"
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    if "--write-fixture" in sys.argv:
        write_fixture()
