"""Related-caption k-NN over embedding banks (the data of ``--use_related_text``).

The port of the JAX package's ``pipeline/related.py``: the banks' text
embeddings, deduplicated by content and normalized, form the related bank;
each record gets its top-k cosine neighbours in it as ``related_embeddings``
[k, E], and the records are appended to a streamed bank (the format the
caption datasets read).

``attach_related`` on a device keeps the normalized bank resident there and
runs one fp32 matmul and ``torch.topk`` per batch of queries; with
``device=None`` it is the JAX package's host path, a numpy ``argsort``.

Run: ``python -m zs_aac_tpu_torch.pipeline.related --input_path a.pkl b.pkl
--output_path out.pkl --topnumber 5`` (``--device cpu`` runs on the CPU; the
default is ``cuda``).
"""

from __future__ import annotations

import argparse
from typing import List, Sequence, Tuple

import numpy as np
import torch

from zs_aac_tpu_torch.data.banks import read_bank, write_bank_stream
from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["load_unique_text_embeddings", "attach_related", "main"]


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def load_unique_text_embeddings(paths: Sequence[str]) -> Tuple[np.ndarray, List[dict]]:
    """Concatenate banks; dedupe text embeddings by byte content:
    (normalized unique embeddings [N, E], all records)."""
    all_data: List[dict] = []
    for p in paths:
        all_data.extend(read_bank(p))
    seen = {}
    for rec in all_data:
        e = np.asarray(rec["text_embedding"], np.float32).reshape(1, -1)
        seen.setdefault(e.tobytes(), e)
    unique = np.concatenate(list(seen.values()), axis=0)
    return _normalize(unique), all_data


def attach_related(bank: np.ndarray, records: List[dict], topnumber: int = 5,
                   batch: int = 256, device="cuda"):
    """Yield records with ``related_embeddings`` [k, E] attached: the rows of
    ``bank`` (normalized unique embeddings [N, E]) nearest each record's
    normalized text embedding. ``device``: a torch device for the resident
    bank, or None for the host path."""
    if device is not None:
        dev = resolve_device(device)
        bank_d = torch.from_numpy(np.ascontiguousarray(bank, np.float32)).to(dev)
    for s in range(0, len(records), batch):
        chunk = records[s:s + batch]
        q = _normalize(np.concatenate(
            [np.asarray(r["text_embedding"], np.float32).reshape(1, -1) for r in chunk]))
        if device is not None:
            sims = torch.from_numpy(q).to(dev) @ bank_d.t()
            idx = torch.topk(sims, topnumber, dim=1).indices.cpu().numpy()
        else:
            idx = np.argsort(-(q @ bank.T), axis=1)[:, :topnumber]
        for r, ids in zip(chunk, idx):
            out = dict(r)
            out["related_embeddings"] = bank[ids]
            yield out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_path", nargs="+", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--topnumber", type=int, default=5)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    bank, records = load_unique_text_embeddings(args.input_path)
    n = write_bank_stream(
        args.output_path,
        attach_related(bank, records, args.topnumber, args.batch, device),
        append=True,  # the reference appends to the output bank
    )
    print(f"wrote {n} records -> {args.output_path}")
    return n


if __name__ == "__main__":
    main()
