"""The port's multilingual (Mistral + LoRA) drivers against the JAX
package's, on the CPU.

- The LoRA train step: 3 steps of ``make_multilingual_train_step`` against
  the same step built from the JAX package's pieces (optax ``adamw`` under
  ``multi_transform`` + ``set_to_zero``, the driver's labels) from one
  converted init, noise 0: losses to rtol 1e-5, the mapper's and LoRA's
  checksums to 1e-5 of each leaf's size. At init LoRA's ``b`` is 0, so
  ``a``'s exact gradient is 0 in the first step in both packages; where a
  gradient is near 0, Adam scales each package's rounding towards the lr
  (``ROADMAP.md`` section C): the last layer's ``wq`` ``b`` parts by 1.5e-6.
- JAX ``train_prompt_multilingual`` (tiny, ``--max_steps 2``, a SentencePiece
  tokenizer and a JAX-written ``--mistral_ckpt``), then both packages'
  ``predict_multilingual`` on its run dir: ``output.txt`` and
  ``scores_{en,zh,fr}.txt`` identical, float and ``--q8 --fuse_qkv on``.
- The port's ``train_prompt_multilingual`` on the same base: its
  ``best.pth`` served by both predict drivers with the same captions.
- The committed ``testdata/tiny_mistral`` fixture: the port's predict
  driver reproduces the JAX-recorded captions exactly and its train step the
  JAX-recorded run within 1e-4 (``train_fixture_errors``).
- Checkpoint dtypes: flax restores a leaf in its stored dtype, not its
  template's; the port serves a base in the dtype it was stored in.

``PYTHONPATH=. python tests/test_torch_multilingual.py --write-fixture``
rewrites ``zs_aac_tpu_torch/testdata/tiny_mistral`` with the JAX package.
"""

import json
import os
import pickle
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zs_aac_tpu_torch import testdata

torch.set_num_threads(2)

E = 16
EN = ["a dog barks loudly in the yard", "rain falls softly on the roof",
      "the wind blows through the trees", "a bird sings in the morning",
      "a car horn blares in the street", "water runs in a small stream"]
ZH = ["狗在院子里大声叫", "雨轻轻地落在屋顶上", "风吹过树林", "鸟在早上唱歌", "汽车在街上鸣笛",
      "水在小溪里流"]
FR = ["un chien aboie fort dans la cour", "la pluie tombe doucement sur le toit",
      "le vent souffle dans les arbres", "un oiseau chante le matin",
      "un klaxon retentit dans la rue", "l'eau coule dans un petit ruisseau"]
TAGS = ["<en>", "<zh>", "<fr>"]


def _cluster(r, k, noise=0.05):
    c = np.zeros(E, np.float32)
    c[(k % 4) * 4:(k % 4 + 1) * 4] = 1.0
    c[k % E] += 0.5
    return (c + noise * r.standard_normal(E)).astype(np.float32)[None]


def write_banks(root):
    """A 24-record train bank (list pickle: no word filter) and a 4-clip
    test bank, English/Chinese/French captions; returns their paths."""
    r = np.random.default_rng(0)
    train = [{"audio_id": f"train{i}", "caption": EN[i % 6], "cn_caption": ZH[i % 6],
              "fr_caption": FR[i % 6], "text_embedding": _cluster(r, i % 6),
              "audio_embedding": _cluster(r, i % 6)} for i in range(24)]
    test = [{"audio_id": f"clip{i}", "audio_embedding": _cluster(r, i),
             "caption": [{"caption": EN[i], "cn_caption": ZH[i], "fr_caption": FR[i]},
                         {"caption": EN[(i + 1) % 6], "cn_caption": ZH[(i + 1) % 6],
                          "fr_caption": FR[(i + 1) % 6]}]} for i in range(4)]
    paths = (os.path.join(root, "train.pkl"), os.path.join(root, "test.pkl"))
    for path, recs in zip(paths, (train, test)):
        with open(path, "wb") as f:
            pickle.dump(recs, f)
    return paths


def write_tokenizer(path):
    words = " ".join(EN + FR).replace("'", " ").split() + TAGS
    return testdata.write_word_bpe_model(path, words, "".join(ZH) + ".,'")


def write_jax_base(path, vocab, seed=11, dtype=jnp.float32):
    from zs_aac_tpu.train.train_prompt_multilingual import _mistral_config
    from zs_aac_tpu.models.mistral import init_mistral
    from zs_aac_tpu.utils.checkpoints import save_params

    save_params(path, init_mistral(jax.random.key(seed), _mistral_config("tiny", vocab), dtype))


def train_args(train, test, out_dir, spm, base, *extra):
    return ["--data", train, "--valdata", test, "--out_dir", out_dir, "--tokenizer", spm,
            "--mistral_ckpt", base, "--mistral_size", "tiny", "--prefix_dim", str(E),
            "--prefix_length", "3", "--prefix_length_clip", "3", "--bs", "8", "--warmup", "0",
            "--lr", "1e-3", "--lora_r", "2", "--lora_alpha", "4", *extra]


def predict_outputs(predict, run, test_bank, dst, flags=()):
    """Run ``predict`` on a copy of ``run``; (output.txt predictions, the
    three scores files' text)."""
    shutil.copytree(run, dst)
    predict(["--test_dir", dst, "--data", test_bank, *flags])
    with open(os.path.join(dst, "output.txt")) as f:
        preds = json.load(f)["predictions"]
    scores = {lang: open(os.path.join(dst, f"scores_{lang}.txt")).read()
              for lang in ("en", "zh", "fr")}
    return preds, scores


MODES = {"float": [], "q8_fused": ["--q8", "--fuse_qkv", "on"]}


def jax_train_record(run_dir, base, steps, lr, weight_decay):
    """The JAX package's LoRA step (the driver's, with noise 0) ``steps``
    times on ``testdata.mistral_train_batch()`` from ``run_dir``'s best.pth
    over ``base``: {"losses", "checksums"} of {"mapper", "lora"}."""
    import optax
    from flax import serialization

    from zs_aac_tpu.models.caption_mistral import (MistralCaptionConfig, init_mistral_caption,
                                                   mistral_caption_loss,
                                                   mistral_caption_train_logits)
    from zs_aac_tpu.models.mistral import MistralConfig
    from zs_aac_tpu.utils.checkpoints import load_params

    fields = testdata.mistral_fixture_config()
    cfg = MistralCaptionConfig(**{**fields, "mistral": MistralConfig(**fields["mistral"])})
    shapes = jax.eval_shape(lambda k: init_mistral_caption(k, cfg), jax.random.key(0))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    head = load_params(os.path.join(run_dir, "best.pth"),
                       {"mapper": template["mapper"], "lora": template["lora"]})
    params = {**head, "mistral": load_params(base, template["mistral"])}
    label_fn = lambda p: {  # noqa: E731  (the driver's)
        "mapper": "trainable",
        "lora": jax.tree.map(lambda _: "trainable", p["lora"]) | {"r": "frozen",
                                                                   "alpha": "frozen"},
        "mistral": "frozen"}
    opt = optax.multi_transform({"trainable": optax.adamw(lr, weight_decay=weight_decay),
                                 "frozen": optax.set_to_zero()}, label_fn)
    state = opt.init(params)

    def loss_fn(p, b):
        logits = mistral_caption_train_logits(p, cfg, b["tokens"], b["prefix"], b["mask"])
        return mistral_caption_loss(logits, b["tokens"], cfg.islang)

    @jax.jit
    def step(p, s, b):
        loss, g = jax.value_and_grad(loss_fn)(p, b)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    batch = {k: jnp.asarray(v) for k, v in testdata.mistral_train_batch().items()}
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    tree = serialization.to_state_dict({"mapper": params["mapper"], "lora": params["lora"]})
    return {"losses": losses, "checksums": testdata.checksums(jax.tree.map(np.asarray, tree))}


def write_fixture(dst=testdata.TINY_MISTRAL_DIR):
    """Rewrite the committed fixture with the JAX package's drivers."""
    import tempfile

    from zs_aac_tpu.train.predict_multilingual import main as j_predict
    from zs_aac_tpu.train.train_prompt_multilingual import main as j_train

    dst = str(dst)
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    train, test = write_banks(dst)
    tok = write_tokenizer(os.path.join(dst, "spm.model"))
    assert tok.vocab_size % 8, tok.vocab_size
    base = os.path.join(dst, "base.msgpack")
    write_jax_base(base, tok.vocab_size)
    with tempfile.TemporaryDirectory() as tmp:
        run = j_train(train_args(train, test, os.path.join(tmp, "runs"),
                                 os.path.join(dst, "spm.model"), base, "--epochs", "3"))
        os.makedirs(os.path.join(dst, "run"))
        shutil.copy(os.path.join(run, "best.pth"), os.path.join(dst, "run", "best.pth"))
        params = json.load(open(os.path.join(run, "params.json")))
        # the paths are the staging copy's (testdata.stage_tiny_mistral)
        params.update(data=["train.pkl"], valdata="test.pkl", tokenizer="spm.model",
                      mistral_ckpt="base.msgpack", out_dir="runs")
        with open(os.path.join(dst, "run", "params.json"), "w") as f:
            json.dump(params, f)
        with open(os.path.join(dst, "expected.json"), "w") as f:
            json.dump({}, f)        # rewritten below; staging reads it
        staged = testdata.stage_tiny_mistral(os.path.join(tmp, "stage"))
        captions = {}
        for mode, flags in MODES.items():
            preds, _ = predict_outputs(j_predict, staged["run_dir"], staged["test_bank"],
                                       os.path.join(tmp, mode), flags)
            captions[mode] = preds
    record = jax_train_record(os.path.join(dst, "run"), base, testdata.MISTRAL_TRAIN_STEPS,
                              **testdata.MISTRAL_TRAIN_OPTIM)
    with open(os.path.join(dst, "expected.json"), "w") as f:
        json.dump({"captions": captions, "train": record}, f, indent=1, ensure_ascii=False)
    print(f"wrote {dst}: vocabulary {tok.vocab_size}, islang {params['islang']}, "
          f"losses {record['losses']}")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fixture_captions_reproduced_on_cpu(tmp_path, mode):
    from zs_aac_tpu_torch.train.predict_multilingual import main as t_predict

    staged = testdata.stage_tiny_mistral(tmp_path / "stage")
    preds, _ = predict_outputs(t_predict, staged["run_dir"], staged["test_bank"],
                               str(tmp_path / "run"), MODES[mode] + ["--device", "cpu"])
    assert preds == staged["expected"]["captions"][mode]


def test_fixture_train_record_reproduced_on_cpu():
    want = json.loads((testdata.TINY_MISTRAL_DIR / "expected.json").read_text())["train"]
    got = testdata.replay_mistral_train_fixture(device="cpu")
    err = testdata.train_fixture_errors(got, want)
    assert err["loss"] <= 1e-4 and err["params"] <= 1e-4, err


def test_fixture_vocabulary_is_not_a_multiple_of_8():
    from zs_aac_tpu_torch.data.sentencepiece import SentencePieceTokenizer

    tok = SentencePieceTokenizer.from_file(str(testdata.TINY_MISTRAL_DIR / "spm.model"))
    assert tok.vocab_size % 8 and testdata.mistral_fixture_config()["mistral"][
        "vocab_size"] == tok.vocab_size


@pytest.mark.parametrize("lr", [1e-3, 1e-2])
def test_lora_train_step_matches_jax_from_one_init(tmp_path, lr):
    """3 steps from one JAX-written init (b = 0, so a's first gradient is
    exactly 0 in both), noise 0, AdamW with decay."""
    from flax import serialization

    from zs_aac_tpu.models.caption_mistral import MistralCaptionConfig, init_mistral_caption
    from zs_aac_tpu.models.mistral import MistralConfig, init_mistral
    from zs_aac_tpu.utils.checkpoints import save_params
    from zs_aac_tpu_torch.models.caption_mistral import MistralCaptionConfig as TCfg
    from zs_aac_tpu_torch.models.convert import from_jax_params, to_jax_params
    from zs_aac_tpu_torch.models.mistral import MistralConfig as TMCfg
    from zs_aac_tpu_torch.train.caption_trainer import tensor_tree
    from zs_aac_tpu_torch.train.train_prompt_multilingual import (MultilingualTrainState,
                                                                  make_multilingual_optimizer,
                                                                  make_multilingual_train_step)

    fields = testdata.mistral_fixture_config()
    cfg = MistralCaptionConfig(**{**fields, "mistral": MistralConfig(**fields["mistral"])})
    init = jax.tree.map(np.asarray, init_mistral_caption(
        jax.random.key(5), cfg, init_mistral(jax.random.key(6), cfg.mistral, jnp.float32)))
    os.makedirs(tmp_path / "run")
    save_params(str(tmp_path / "run" / "best.pth"), {"mapper": init["mapper"],
                                                     "lora": init["lora"]})
    save_params(str(tmp_path / "base.msgpack"), init["mistral"])
    want = jax_train_record(str(tmp_path / "run"), str(tmp_path / "base.msgpack"), 3, lr, 0.01)

    tcfg = TCfg(**{**fields, "mistral": TMCfg(**fields["mistral"])})
    params = from_jax_params(serialization.to_state_dict(init), device="cpu")
    opt = make_multilingual_optimizer(lr, 0.01)
    state = MultilingualTrainState(params, opt.init(tensor_tree(params)), 0)
    step = make_multilingual_train_step(tcfg, opt, 0.0, device="cpu")
    base_before = params["mistral"]["embed"].clone()
    batch = testdata.mistral_train_batch()
    losses = []
    for _ in range(3):
        state, loss = step(state, batch, 0)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    got = testdata.checksums(to_jax_params({"mapper": state.params["mapper"],
                                            "lora": state.params["lora"]}))
    err = testdata.train_fixture_errors({"losses": losses, "checksums": got}, want)
    assert err["params"] <= 1e-5, err
    assert torch.equal(state.params["mistral"]["embed"], base_before)
    assert float(state.params["lora"]["r"]) == fields["lora_r"]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX train_prompt_multilingual, tiny, --max_steps 2, over a
    JAX-written base, with a SentencePiece tokenizer."""
    from zs_aac_tpu.train.train_prompt_multilingual import main as j_train

    root = str(tmp_path_factory.mktemp("multilingual"))
    train, test = write_banks(root)
    spm = os.path.join(root, "spm.model")
    tok = write_tokenizer(spm)
    base = os.path.join(root, "base.msgpack")
    write_jax_base(base, tok.vocab_size)
    run = j_train(train_args(train, test, os.path.join(root, "runs"), spm, base,
                             "--epochs", "1", "--max_steps", "2"))
    return {"root": root, "train": train, "test": test, "spm": spm, "base": base, "run": run}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_both_predict_drivers_agree_on_a_jax_run(jax_run, tmp_path, mode):
    from zs_aac_tpu.train.predict_multilingual import main as j_predict
    from zs_aac_tpu_torch.train.predict_multilingual import main as t_predict

    jp, js = predict_outputs(j_predict, jax_run["run"], jax_run["test"], str(tmp_path / "jax"),
                             MODES[mode])
    tp, ts = predict_outputs(t_predict, jax_run["run"], jax_run["test"],
                             str(tmp_path / "port"), MODES[mode] + ["--device", "cpu"])
    assert tp == jp and len(tp) == 4 and set(tp[0]) == {"filename", "caption_en",
                                                       "caption_zh", "caption_fr"}
    assert ts == js


def test_jax_predict_serves_the_port_train_run(jax_run, tmp_path):
    from zs_aac_tpu.train.predict_multilingual import main as j_predict
    from zs_aac_tpu_torch.train.predict_multilingual import main as t_predict
    from zs_aac_tpu_torch.train.train_prompt_multilingual import main as t_train

    run = t_train(train_args(jax_run["train"], jax_run["test"], str(tmp_path / "runs"),
                             jax_run["spm"], jax_run["base"], "--epochs", "1",
                             "--max_steps", "2", "--device", "cpu"))
    for name in ("params.json", "train_caption.log", "best.pth", "last.pth"):
        assert os.path.exists(os.path.join(run, name)), name
    mine = json.load(open(os.path.join(run, "params.json")))
    theirs = json.load(open(os.path.join(jax_run["run"], "params.json")))
    assert sorted(set(mine) - {"device"}) == sorted(theirs)
    assert (mine["islang"], mine["mistral_vocab_size"]) == (theirs["islang"],
                                                            theirs["mistral_vocab_size"])
    jp, _ = predict_outputs(j_predict, run, jax_run["test"], str(tmp_path / "jax"))
    tp, _ = predict_outputs(t_predict, run, jax_run["test"], str(tmp_path / "port"),
                            ["--device", "cpu"])
    assert tp == jp and len(tp) == 4


def test_flax_restores_the_stored_dtype_and_the_port_serves_it(tmp_path):
    """JAX ``predict_multilingual`` restores the base into a bf16 template,
    but flax keeps each leaf's stored dtype: an fp32 base is served in fp32,
    a bf16 one in bf16. ``load_mistral_base`` does the same."""
    from zs_aac_tpu.models.mistral import MistralConfig, init_mistral
    from zs_aac_tpu.utils.checkpoints import load_params, save_params
    from zs_aac_tpu_torch.train.train_prompt_multilingual import load_mistral_base

    cfg = MistralConfig(vocab_size=40, hidden_size=32, n_layers=1, n_heads=4, n_kv_heads=2,
                        intermediate_size=64)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda k: init_mistral(k, cfg), jax.random.key(0)))
    assert template["embed"].dtype == jnp.bfloat16
    for name, dtype, want in (("f32", jnp.float32, torch.float32),
                              ("bf16", jnp.bfloat16, torch.bfloat16)):
        path = str(tmp_path / f"{name}.msgpack")
        save_params(path, init_mistral(jax.random.key(1), cfg, dtype))
        restored = load_params(path, template)
        assert restored["embed"].dtype == dtype and restored["layers"][0]["attn"]["wq"].dtype \
            == dtype
        base = load_mistral_base(path, "cpu")
        assert base["embed"].dtype == want and base["layers"][0]["mlp"]["up"].dtype == want
        assert np.array_equal(base["embed"].float().numpy(),
                              np.asarray(restored["embed"], np.float32))


@pytest.mark.parametrize("text", ["A Dog barks!", "狗在叫。", "Un chien aboie, fort.",
                                  "l'eau coule", "  Mixed 42 Café  ", ""])
@pytest.mark.parametrize("lang", ["en", "zh", "fr"])
def test_tokenize_lang_matches_jax(text, lang):
    from zs_aac_tpu.train.predict_multilingual import tokenize_lang as j_tok
    from zs_aac_tpu_torch.train.predict_multilingual import tokenize_lang as t_tok

    assert t_tok(text, lang) == j_tok(text, lang)


@pytest.mark.parametrize("size", ["tiny", "7b"])
def test_driver_constants_match_jax(size):
    import dataclasses

    from zs_aac_tpu.train import predict_multilingual as jpm
    from zs_aac_tpu.train import train_prompt_multilingual as jtm
    from zs_aac_tpu_torch.train import predict_multilingual as tpm
    from zs_aac_tpu_torch.train import train_prompt_multilingual as ttm

    assert ttm.LANG_TAGS == jtm.LANG_TAGS and tpm.REF_FIELD == jpm.REF_FIELD
    assert tuple(tpm.LANGS) == tuple(jpm.LANGS)
    assert dataclasses.asdict(ttm._mistral_config(size, 301)) == \
        dataclasses.asdict(jtm._mistral_config(size, 301))
    jflags = {a.dest: a.default for a in jtm.build_parser()._actions}
    tflags = {a.dest: a.default for a in ttm.build_parser()._actions}
    assert tflags.pop("device") == "cuda" and tflags == jflags


def test_word_tokenizer_tags_count_the_same(jax_run):
    """Without ``--tokenizer`` both drivers extend the word tokenizer with
    the tags, so ``islang`` and the tag ids agree."""
    from zs_aac_tpu.train.train_prompt import _make_tokenizer as j_make
    from zs_aac_tpu.train.train_prompt_multilingual import LANG_TAGS
    from zs_aac_tpu_torch.train.train_prompt import _make_tokenizer as t_make
    from zs_aac_tpu_torch.train.train_prompt_multilingual import extend_with_lang_tags

    class _A:
        tokenizer = None

    jt, _ = j_make(_A, [jax_run["train"]])
    for tag in LANG_TAGS.values():
        if tag not in jt.stoi:
            jt.stoi[tag] = len(jt.itos)
            jt.itos.append(tag)
    tt = extend_with_lang_tags(t_make(None, [jax_run["train"]])[0])
    assert tt.vocab_size == jt.vocab_size
    for tag in LANG_TAGS.values():
        assert tt.encode(tag) == jt.encode(tag) and len(tt.encode(tag)) == 1
        assert tt.encode(f"{tag}a dog barks.") == jt.encode(f"{tag}a dog barks.")


if __name__ == "__main__":
    if "--write-fixture" in sys.argv:
        write_fixture()
