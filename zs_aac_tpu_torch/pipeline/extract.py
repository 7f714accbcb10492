"""Embedding-bank extraction: the encode half of the zero-shot pipeline.

The counterpart of the JAX package's ``pipeline/extract.py`` (the reference
``data_handing/embeddings_generator.py`` and its per-corpus text variants
under ``--corpus``): clips listed in ``<split>/wav.csv`` + ``text.json`` are
decoded, padded to ``max_length`` seconds and encoded in batches (log-mel ->
HTSAT -> projection), their captions through BERT, and the records written
to ``<out>/<split>/clap_embedding/ZS/data.pkl``.

On the card the encoders run the hand-written kernels: K2 (log-mel), K3 (the
whole Swin block) in every HTSAT stage but the last, and K5 (window
attention) in the last stage, the TPU dispatch. Without a checkpoint the
weights are seeded random ones; a checkpoint is either a train state that the
port's ``pretrain`` or ``finetune`` driver wrote (``best_model.ckpt``) or a
reference-layout ``.pt`` file, both read with ``torch.load(weights_only=True)``
(``utils.checkpoints.load_ase_variables``). An orbax train-state directory of
the JAX package is converted first by ``examples/convert_jax_state.py``; a
directory raises a ``ValueError`` naming it.

Run (``--config`` is read by ``utils.config.load_config``, the YAML subset of
the repo's configs, or JSON; the CSV corpora by the ``csv`` module):
  python -m zs_aac_tpu_torch.pipeline.extract --config configs/extract_data.yaml \\
      --dataset_path data/clotho --out_path data/clotho --device cuda
  python -m zs_aac_tpu_torch.pipeline.extract --corpus audioset --text_input \\
      class_labels_indices.csv --out_path data/audioset_label.pkl
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from zs_aac_tpu_torch.data.audio_io import load_audio, pad_or_truncate
from zs_aac_tpu_torch.data.banks import write_bank_list
from zs_aac_tpu_torch.data.text_transform import text_preprocess
from zs_aac_tpu_torch.train.pretrain import build_ase_from_config

__all__ = [
    "load_ase_encoders",
    "extract_audio_text_bank",
    "extract_text_bank",
    "main",
]


def load_ase_encoders(config: dict, ckpt: Optional[str] = None, device="cuda"):
    """Batched ``(encode_audio(waves), encode_text(texts))`` from a config and
    an optional checkpoint (a train state of the port's training drivers or a
    reference-layout file); numpy in, fp32 numpy out.
    ``encode_audio.pcm(pcm, sr_in, target_len)`` takes int16 PCM at the
    files' native rate and resamples on the device."""
    from zs_aac_tpu_torch.data.bert_tokenizer import WordPieceTokenizer
    from zs_aac_tpu_torch.models.ase import init_ase
    from zs_aac_tpu_torch.models.convert import cast_floating
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.ops.resample import resample_poly_device
    from zs_aac_tpu_torch.train.contrastive import make_encode_fns
    from zs_aac_tpu_torch.utils.checkpoints import load_ase_variables
    from zs_aac_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    tokenizer = WordPieceTokenizer.from_file(config["text_encoder_args"]["vocab"])
    ase, cfg = build_ase_from_config(config, device=dev)
    mel_cfg = LogMelConfig.from_dict(config["audio_args"])
    path = ckpt or config.get("pretrain_path")
    if path and os.path.exists(path):
        variables = load_ase_variables(path, cfg, device=dev)
    else:
        variables = init_ase(cfg, seed=0, device=dev)
    if cfg.dtype == torch.bfloat16:
        variables = cast_floating(variables, torch.bfloat16)
    enc_a, enc_t = make_encode_fns(ase, mel_cfg, device=dev)

    def encode_audio(waves: np.ndarray) -> np.ndarray:
        return enc_a(variables, torch.from_numpy(np.asarray(waves))).float().cpu().numpy()

    def encode_audio_pcm(pcm: np.ndarray, sr_in: int, target_len: int) -> np.ndarray:
        waves = resample_poly_device(torch.from_numpy(np.asarray(pcm)).to(dev), sr_in,
                                     mel_cfg.sr, target_len)
        return enc_a(variables, waves).float().cpu().numpy()

    encode_audio.pcm = encode_audio_pcm

    def encode_text(texts: Sequence[str]) -> np.ndarray:
        ids, mask = tokenizer.batch_encode([text_preprocess(t) for t in texts],
                                           max_length=30, pad_to_max=True)
        return enc_t(variables, torch.from_numpy(ids), torch.from_numpy(mask)).float().cpu().numpy()

    return encode_audio, encode_text


def _batched_texts(encode_text, texts: List[str], batch: int) -> np.ndarray:
    out = [encode_text(texts[s : s + batch]) for s in range(0, len(texts), batch)]
    return np.concatenate(out) if out else np.zeros((0, 0), np.float32)


def extract_audio_text_bank(encode_audio: Callable, encode_text: Callable, data_path: str,
                            with_text: bool, audio_args: dict,
                            batch_size: int = 32) -> List[dict]:
    """wav.csv + text.json -> bank records (the reference
    embeddings_generator's records). The host decodes batch i+1 while the
    device encodes batch i; where every clip of a batch is an 8/16-bit WAV
    of one native rate, int16 PCM is shipped and resampled on the device."""
    import csv
    from concurrent.futures import ThreadPoolExecutor

    with open(os.path.join(data_path, "wav.csv")) as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    id2file = {r["audio_id"]: r["file_name"] for r in rows}
    with open(os.path.join(data_path, "text.json")) as f:
        audios = json.load(f)["audios"]

    sr = audio_args["sr"]
    max_length = audio_args.get("max_length", 10)
    n = max_length * sr
    use_pcm = hasattr(encode_audio, "pcm")

    def load_chunk(chunk):
        """("pcm", int16 [B, max_length*sr_native], sr_native) or ("f32",
        float32 [B, n], None) after the full host decode + resample."""
        if use_pcm:
            from zs_aac_tpu_torch.data.audio_io import load_audio_raw

            raws = [load_audio_raw(id2file[a["audio_id"]]) for a in chunk]
            srs = {r[1] for r in raws if r is not None}
            if all(r is not None for r in raws) and len(srs) == 1:
                sr_in = srs.pop()
                n_in = max_length * sr_in
                return "pcm", np.stack([pad_or_truncate(r[0], n_in) for r in raws]), sr_in
        return "f32", np.stack([pad_or_truncate(load_audio(id2file[a["audio_id"]], sr), n)
                                for a in chunk]), None

    chunks = []
    for s in range(0, len(audios), batch_size):
        chunk = [a for a in audios[s : s + batch_size] if os.path.exists(id2file[a["audio_id"]])]
        if chunk:
            chunks.append(chunk)

    out: List[dict] = []
    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = ex.submit(load_chunk, chunks[0]) if chunks else None
        for ci, chunk in enumerate(chunks):
            kind, waves, sr_in = pending.result()
            pending = ex.submit(load_chunk, chunks[ci + 1]) if ci + 1 < len(chunks) else None
            audio_embs = encode_audio.pcm(waves, sr_in, n) if kind == "pcm" else encode_audio(waves)
            if with_text:
                caps, owners = [], []
                for i, a in enumerate(chunk):
                    for c in a["captions"]:
                        caps.append(c["caption"])
                        owners.append(i)
                text_embs = _batched_texts(encode_text, caps, batch_size)
                for cap, owner, temb in zip(caps, owners, text_embs):
                    out.append({"audio_embedding": audio_embs[owner : owner + 1],
                                "caption": cap, "text_embedding": temb[None],
                                "audio_id": chunk[owner]["audio_id"]})
            else:
                for i, a in enumerate(chunk):
                    out.append({"audio_embedding": audio_embs[i : i + 1],
                                "caption": a["captions"], "text_embedding": 0,
                                "audio_id": a["audio_id"]})
    return out


def _csv_column(path: str, name: str) -> List[str]:
    """One column of a comma-separated file with a header row, as
    ``pandas.read_csv(path)[name]`` gives it for text: quoted fields with
    commas or quotes unquoted, blank lines skipped, an empty cell as
    ``"nan"`` (the string of pandas' missing value)."""
    import csv

    with open(path, newline="", encoding="utf-8") as f:
        return [row[name] if row[name] else "nan" for row in csv.DictReader(f)]


def _corpus_texts(corpus: str, path: str) -> List[dict]:
    """{caption}-bearing rows of each supported text corpus."""
    if corpus == "wavcaps_json":
        with open(path) as f:
            obj = json.load(f)
        rows = []
        n = obj["num_captions_per_audio"]
        for i, item in enumerate(obj["data"]):
            if n == 1:
                rows.append({"caption": item["caption"].strip(), "text_id": i})
            else:
                for j in range(1, n + 1):
                    rows.append({"caption": item[f"caption_{j}"].strip(),
                                 "text_id": i * n + j})
        return rows
    if corpus == "msd":  # sentence split + 5..20 word filter
        with open(path, "rb") as f:
            data = pickle.load(f)
        return [{"caption": sent.strip()} for row in data
                for sent in row["caption"].split(". ") if 5 <= len(sent.split()) <= 20]
    if corpus == "musiccaps":  # the reference's len() comparison, fixed
        return [{"caption": sent.strip()} for cap in _csv_column(path, "caption")
                for sent in cap.split(". ") if 5 <= len(sent.split()) <= 20]
    if corpus == "coco":
        with open(path) as f:
            anns = json.load(f)["annotations"]
        return [{"caption": a["caption"].strip(), "text_id": i} for i, a in enumerate(anns)]
    if corpus == "chatgpt":
        with open(path) as f:
            lines = [l.strip() for l in f]
        return [{"caption": l, "text_id": i} for i, l in enumerate(lines) if len(l) > 1]
    if corpus == "audioset":  # label bank
        return [{"label": name, "label_id": i}
                for i, name in enumerate(_csv_column(path, "display_name"))]
    raise ValueError(f"unknown corpus {corpus!r}")


def extract_text_bank(encode_text: Callable, corpus: str, path: str,
                      batch_size: int = 64) -> List[dict]:
    rows = _corpus_texts(corpus, path)
    key = "label" if corpus == "audioset" else "caption"
    embs = _batched_texts(encode_text, [r[key] for r in rows], batch_size)
    out = []
    for r, e in zip(rows, embs):
        rec = dict(r)
        rec["label_embedding" if corpus == "audioset" else "text_embedding"] = e[None]
        out.append(rec)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="configs/extract_data.yaml")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--dataset_path", default=None, help="dir with <split>/wav.csv")
    p.add_argument("--out_path", required=True)
    p.add_argument("--corpus", default=None,
                   choices=[None, "wavcaps_json", "msd", "musiccaps", "coco", "chatgpt",
                            "audioset"])
    p.add_argument("--text_input", default=None, help="corpus input file")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from zs_aac_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    from zs_aac_tpu_torch.utils.config import load_config

    config = load_config(args.config)
    encode_audio, encode_text = load_ase_encoders(config, args.ckpt, device=args.device)

    if args.corpus:
        out = extract_text_bank(encode_text, args.corpus, args.text_input, args.batch)
        os.makedirs(os.path.dirname(args.out_path) or ".", exist_ok=True)
        write_bank_list(args.out_path, out)
        print(f"wrote {len(out)} records -> {args.out_path}")
        return

    for split in args.splits:
        data_path = os.path.join(args.dataset_path, split)
        print(f"---Extract the embeddings of {split} set---", flush=True)
        out = extract_audio_text_bank(encode_audio, encode_text, data_path, split == "train",
                                      config["audio_args"], args.batch)
        dst = os.path.join(args.out_path, split, "clap_embedding", "ZS")
        os.makedirs(dst, exist_ok=True)
        write_bank_list(os.path.join(dst, "data.pkl"), out)
        print(f"wrote {len(out)} records -> {dst}/data.pkl")


if __name__ == "__main__":
    main()
