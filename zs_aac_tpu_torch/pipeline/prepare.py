"""Dataset preparation: raw corpus layouts -> wav.csv/text.json manifests.

A copy of the JAX package's ``pipeline/prepare.py`` (the reference's
``prepare_clotho.py`` and ``prepare_audiocaps.py``): md5-hashed audio ids, a
symlink farm of ``<audio_id>.wav`` files, per-split ``wav.csv`` (TSV
audio_id/file_name) and ``text.json`` ({audios: [{audio_id, captions:
[{caption, cap_id}], raw_name}]}).

The port reads and writes the tables with the ``csv`` module instead of
pandas (which the card machine lacks), and writes the same bytes as the JAX
package's ``to_csv(sep="\\t", index=False)`` and ``json.dump(indent=4)``:
fields holding a tab, a quote or a line break quoted, ``"`` doubled, rows
ended by ``\\n``. Annotation cells are read as ``pandas.read_csv`` gives
them for these layouts: quoted fields unquoted, blank lines skipped, an
empty cell as pandas' missing value (NaN: ``NaN`` in ``text.json`` for a
Clotho caption, ``"nan"`` for an AudioCaps one, which the JAX package turns
into a string).

Run:
  python -m zs_aac_tpu_torch.pipeline.prepare clotho <root> <out> [--version 2]
  python -m zs_aac_tpu_torch.pipeline.prepare audiocaps <root> <out> --audioset_csv wav.csv
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import json
import shutil
from pathlib import Path
from typing import Dict, List

__all__ = ["prepare_clotho_split", "prepare_audiocaps_split", "main"]


def _read_table(path: Path, delimiter: str = ",") -> List[Dict[str, object]]:
    """A CSV/TSV with a header row, as ``pandas.read_csv`` reads the repo's
    text layouts: an empty cell is NaN."""
    with open(path, newline="", encoding="utf-8") as f:
        return [{k: (v if v != "" else float("nan")) for k, v in row.items()}
                for row in csv.DictReader(f, delimiter=delimiter)]


def _emit(output_path: Path, split: str, rows, data):
    out = output_path / split
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "wav.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        if rows:
            w.writerow(list(rows[0]))
            w.writerows([list(r.values()) for r in rows])
        else:
            f.write("\n")           # pandas' empty frame
    with open(out / "text.json", "w") as f:
        json.dump({"audios": data}, f, indent=4)


def prepare_clotho_split(split: str, annotation_path: Path, audio_path: Path,
                         encoded_audio_path: Path, output_path: Path) -> int:
    table = _read_table(annotation_path / f"{split}.csv")
    audio_path = audio_path / split
    data, rows = [], []
    for row in table:
        raw = Path(row["file_name"]).stem
        audio_id = hashlib.md5(f"{split}_{raw}".encode()).hexdigest()
        link = encoded_audio_path / f"{audio_id}.wav"
        if not link.exists():
            link.symlink_to(audio_path.resolve() / row["file_name"])
        rows.append({"audio_id": audio_id, "file_name": str(link.absolute())})
        item = {"audio_id": audio_id, "captions": [], "raw_name": row["file_name"]}
        for cap_id in range(1, 6):
            item["captions"].append(
                {"caption": row[f"caption_{cap_id}"], "cap_id": str(cap_id)}
            )
        data.append(item)
    _emit(output_path, split, rows, data)
    return len(data)


def prepare_audiocaps_split(split: str, annotation_path: Path, audioset_csv: Path,
                            encoded_audio_path: Path, output_path: Path) -> int:
    """Join the AudioCaps csv (audiocap_id, youtube_id, caption) with an
    AudioSet wav listing by youtube_id (prepare_audiocaps.py:8-69)."""
    table = _read_table(annotation_path / f"{split}.csv")
    yt2path = {}
    for r in _read_table(audioset_csv, delimiter="\t"):
        name = Path(r["file_name"]).stem
        yt2path[name[:11]] = r["file_name"]  # youtube ids are 11 chars

    grouped = {}
    for row in table:
        yt = row["youtube_id"]
        if yt not in yt2path:
            continue
        grouped.setdefault(yt, []).append(str(row["caption"]))

    data, rows = [], []
    for yt, caps in grouped.items():
        audio_id = hashlib.md5(f"{split}_{yt}".encode()).hexdigest()
        link = encoded_audio_path / f"{audio_id}.wav"
        if not link.exists():
            link.symlink_to(Path(yt2path[yt]).resolve())
        rows.append({"audio_id": audio_id, "file_name": str(link.absolute())})
        data.append(
            {
                "audio_id": audio_id,
                "captions": [
                    {"caption": c, "cap_id": str(i + 1)} for i, c in enumerate(caps)
                ],
                "raw_name": yt,
            }
        )
    _emit(output_path, split, rows, data)
    return len(data)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dataset", choices=["clotho", "audiocaps"])
    p.add_argument("root_dir")
    p.add_argument("output_path")
    p.add_argument("--version", type=int, default=2, choices=[1, 2])
    p.add_argument("--audioset_csv", default=None)
    args = p.parse_args(argv)

    root = Path(args.root_dir)
    out = Path(args.output_path)
    hashed = out / "hashed_audio"
    if hashed.exists():
        shutil.rmtree(hashed)
    hashed.mkdir(parents=True, exist_ok=True)

    if args.dataset == "clotho":
        splits = ["dev", "eval"] if args.version == 1 else ["dev", "val", "eval"]
        for split in splits:
            n = prepare_clotho_split(split, root / "annotation", root / "audio",
                                     hashed, out)
            print(f"{split}: {n} audios")
    else:
        if not args.audioset_csv:
            raise SystemExit("audiocaps needs --audioset_csv")
        for split in ["train", "val", "test"]:
            n = prepare_audiocaps_split(split, root, Path(args.audioset_csv),
                                        hashed, out)
            print(f"{split}: {n} audios")


if __name__ == "__main__":
    main()
