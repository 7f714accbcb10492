"""The port's SentencePiece tokenizer against the JAX package's, on the CPU.

Model files are written offline with ``write_model`` (unigram and BPE, with
byte fallback and control pieces, with and without the dummy prefix); both
packages read the same file and must give the same ids for every text and
the same decode of every id sequence, exactly. The ``.model`` branch of each
package's ``_make_tokenizer`` gives the same stop id.
"""

import argparse

import numpy as np
import pytest

from zs_aac_tpu.data import sentencepiece as jsp
from zs_aac_tpu_torch.data import sentencepiece as tsp

WS = "▁"
TEXTS = ["the cat", "a cat the", "ttat", "the caté 猫", "the<s>cat", " a", "a", "",
         "abcb", "az", "<en>a dog barks.", "狗在叫。", "un chien aboie, fort."]


def _specials():
    return [("<unk>", 0.0, jsp.UNKNOWN), ("<s>", 0.0, jsp.CONTROL), ("</s>", 0.0, jsp.CONTROL)]


def _bytes():
    return [(f"<0x{b:02X}>", 0.0, jsp.BYTE) for b in range(256)]


MODELS = {
    "unigram": (jsp.UNIGRAM, True, _specials() + [
        (WS + "the", -1.0, jsp.NORMAL), (WS + "cat", -2.0, jsp.NORMAL), (WS + "c", -4.0, jsp.NORMAL),
        ("at", -3.0, jsp.NORMAL), ("a", -5.0, jsp.NORMAL), ("t", -5.0, jsp.NORMAL),
        (WS, -6.0, jsp.NORMAL), (".", -2.5, jsp.NORMAL)] + _bytes()),
    "bpe": (jsp.BPE, True, _specials() + [
        (WS, -10.0, jsp.NORMAL), ("a", -11.0, jsp.NORMAL), ("b", -12.0, jsp.NORMAL),
        ("c", -13.0, jsp.NORMAL), ("ab", -1.0, jsp.NORMAL), ("abc", -2.0, jsp.NORMAL),
        (WS + "abc", -0.5, jsp.NORMAL), (WS + "a", -3.0, jsp.NORMAL)] + _bytes()),
    "no_dummy_prefix": (jsp.UNIGRAM, False, _specials() + [
        ("a", -1.0, jsp.NORMAL), (WS, -2.0, jsp.NORMAL), (WS + "a", -0.5, jsp.NORMAL)] + _bytes()),
    "no_byte_fallback": (jsp.BPE, True, _specials() + [
        (WS, -1.0, jsp.NORMAL), ("a", -2.0, jsp.NORMAL), (WS + "a", -0.5, jsp.NORMAL)]),
}


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("spm")
    out = {}
    for name, (mtype, dummy, pieces) in MODELS.items():
        path = str(root / f"{name}.model")
        jsp.write_model(path, pieces, model_type=mtype, add_dummy_prefix=dummy)
        out[name] = path
    return out


def test_write_model_writes_the_same_bytes(tmp_path):
    for name, (mtype, dummy, pieces) in MODELS.items():
        a, b = str(tmp_path / f"j_{name}.model"), str(tmp_path / f"t_{name}.model")
        jsp.write_model(a, pieces, model_type=mtype, add_dummy_prefix=dummy)
        tsp.write_model(b, pieces, model_type=mtype, add_dummy_prefix=dummy)
        assert open(a, "rb").read() == open(b, "rb").read(), name


@pytest.mark.parametrize("name", sorted(MODELS))
def test_metadata_equal(model_files, name):
    j = jsp.SentencePieceTokenizer.from_file(model_files[name])
    t = tsp.SentencePieceTokenizer.from_file(model_files[name])
    assert (t.model_type, t.add_dummy_prefix, t.unk_id, t.bos_id, t.eos_id, t.vocab_size) == \
        (j.model_type, j.add_dummy_prefix, j.unk_id, j.bos_id, j.eos_id, j.vocab_size)
    assert t.pieces == j.pieces and t.byte_pieces == j.byte_pieces


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("text", TEXTS)
def test_encode_decode_equal(model_files, name, text):
    j = jsp.SentencePieceTokenizer.from_file(model_files[name])
    t = tsp.SentencePieceTokenizer.from_file(model_files[name])
    for bos, eos in ((False, False), (True, True)):
        ids = j.encode(text, add_bos=bos, add_eos=eos)
        assert t.encode(text, add_bos=bos, add_eos=eos) == ids
        assert t.decode(ids) == j.decode(ids)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_decode_of_random_ids_equal(model_files, name):
    """Any id sequence (bytes that do not form UTF-8, control and unknown
    pieces, ids out of range) decodes to the same string."""
    j = jsp.SentencePieceTokenizer.from_file(model_files[name])
    t = tsp.SentencePieceTokenizer.from_file(model_files[name])
    rng = np.random.default_rng(0)
    for _ in range(50):
        ids = [int(i) for i in rng.integers(-2, j.vocab_size + 3, int(rng.integers(0, 12)))]
        assert t.decode(ids) == j.decode(ids), ids


@pytest.mark.parametrize("pieces, want", [
    ([(WS + "a", -1.0, jsp.NORMAL), (".", -2.0, jsp.NORMAL)], "piece"),
    ([(WS + "a", -1.0, jsp.NORMAL)], "byte"),
    ([(WS + "a", -1.0, jsp.NORMAL)], "eos"),
])
def test_make_tokenizer_stop_id_equal(tmp_path, pieces, want):
    from zs_aac_tpu.train.train_prompt import _make_tokenizer as j_make
    from zs_aac_tpu_torch.train.train_prompt import _make_tokenizer as t_make

    path = str(tmp_path / "tok.model")
    jsp.write_model(path, _specials() + pieces + (_bytes() if want != "eos" else []),
                    model_type=jsp.BPE)
    jtok, jstop = j_make(argparse.Namespace(tokenizer=path), [])
    ttok, tstop = t_make(path, [])
    assert isinstance(ttok, tsp.SentencePieceTokenizer)
    assert tstop == jstop
    expect = {"piece": ttok.piece_to_id.get("."), "byte": ttok.byte_pieces.get(ord(".")),
              "eos": ttok.eos_id}[want]
    assert tstop == expect
