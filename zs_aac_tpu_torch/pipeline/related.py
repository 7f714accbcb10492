"""Related-caption k-NN over embedding banks (the data of ``--use_related_text``).

The port of the JAX package's ``pipeline/related.py``: the banks' text
embeddings, deduplicated by content and normalized, form the related bank;
each record gets its top-k cosine neighbours in it as ``related_embeddings``
[k, E], and the records are appended to a streamed bank (the format the
caption datasets read).

``attach_related`` on a device keeps the normalized bank resident there and
runs one fp32 matmul and a top-k per batch of queries (a stable descending
sort: equal similarities go to the lower bank index); with ``device=None``
it is the JAX package's host path, a numpy ``argsort``. Under a ``mesh``
(its ``data`` dim; the JAX package's multichip bank scan) each rank holds a
contiguous block of the bank's rows and takes the top-k of its block for
every query (the queries are replicated); the blocks' candidates are
gathered in rank order and merged by the same stable sort, so the result is
the one-process top-k.

Run: ``python -m zs_aac_tpu_torch.pipeline.related --input_path a.pkl b.pkl
--output_path out.pkl --topnumber 5`` (``--device cpu`` runs on the CPU; the
default is ``cuda``); under ``torchrun`` the bank is split over the ranks
and rank 0 writes the output.
"""

from __future__ import annotations

import argparse
from typing import List, Sequence, Tuple

import numpy as np
import torch

from zs_aac_tpu_torch.data.banks import read_bank, write_bank_stream
from zs_aac_tpu_torch.parallel.mesh import gather_rows, mesh_axis
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


def _topk(sims, k: int):
    """(values, indices) of the ``k`` largest of each row, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def attach_related(bank: np.ndarray, records: List[dict], topnumber: int = 5,
                   batch: int = 256, device="cuda", mesh=None):
    """Yield records with ``related_embeddings`` [k, E] attached: the rows of
    ``bank`` (normalized unique embeddings [N, E]) nearest each record's
    normalized text embedding. ``device``: a torch device for the resident
    bank, or None for the host path. ``mesh``: split the bank over its
    ``data`` ranks (module docstring); every rank yields every record."""
    data = mesh_axis(mesh, "data")
    if device is not None:
        dev = resolve_device(device)
        lo, hi = 0, len(bank)
        if data is not None:
            block = -(-len(bank) // data.size)
            lo, hi = min(len(bank), data.rank * block), min(len(bank), (data.rank + 1) * block)
        bank_d = torch.from_numpy(np.ascontiguousarray(bank[lo:hi], np.float32)).to(dev)
    for s in range(0, len(records), batch):
        chunk = records[s:s + batch]
        q = _normalize(np.concatenate(
            [np.asarray(r["text_embedding"], np.float32).reshape(1, -1) for r in chunk]))
        if device is not None:
            vals, idx = _topk(torch.from_numpy(q).to(dev) @ bank_d.t(), topnumber)
            if data is not None:
                # each block's k best, -inf past a short block, in rank order
                pad = topnumber - vals.shape[1]
                vals = torch.cat([vals, vals.new_full((len(q), pad), -torch.inf)], dim=1)
                idx = torch.cat([idx + lo, idx.new_zeros((len(q), pad))], dim=1)
                vals = gather_rows(vals.t().contiguous(), data).t()
                idx = gather_rows(idx.t().contiguous(), data).t()
                _, pos = _topk(vals, topnumber)
                idx = idx.gather(1, pos)
            idx = idx.cpu().numpy()
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

    from zs_aac_tpu_torch.parallel.mesh import (destroy_distributed, init_distributed,
                                                is_main_process, make_mesh)

    device = init_distributed(args.device)
    try:
        bank, records = load_unique_text_embeddings(args.input_path)
        rows = attach_related(bank, records, args.topnumber, args.batch, device, make_mesh())
        if not is_main_process():
            for _ in rows:     # the other ranks scan their blocks for rank 0
                pass
            return 0
        n = write_bank_stream(args.output_path, rows,
                              append=True)  # the reference appends to the output bank
        print(f"wrote {n} records -> {args.output_path}")
        return n
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
