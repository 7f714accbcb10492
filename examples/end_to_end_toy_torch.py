#!/usr/bin/env python3
"""End-to-end toy run of the zero-shot AAC chain through the PyTorch port.

The port's analogue of ``examples/end_to_end_toy.py``: the same synthetic
corpus (24 two-second pure tones, 8 classes, each clip captioned "a <class>
sound in the audio."), vocabulary, config values and flags, with every stage
a CLI of ``zs_aac_tpu_torch`` run as a subprocess on ``--device``:

  1. pipeline.prepare          raw corpus -> wav.csv/text.json manifests
  2. train.pretrain -c         CLAP contrastive training
  3. pipeline.extract          embedding banks from the trained CLAP
  4. pipeline.extract --corpus audioset   label bank for hard prompts
  5. pipeline.related          kNN related-caption augmentation
  6. train.train_prompt        zero-shot captioner on TEXT embeddings
                               (--sound_effect, --use_related_text)
  7. train.predict_prompt --isbeam   caption AUDIO embeddings + scores
  8. the supervised sanity path: train_prompt on AUDIO embeddings and
     predict_prompt (no modality gap: the captions should name the class)

The config is written as JSON (``utils.config.load_config`` reads it); the
script uses neither pyyaml nor pandas and imports nothing of the JAX package.
``run_toy(root, device, epochs)`` runs the stages and returns the paths
they wrote; ``file_contracts`` lists the files each stage must leave and
``supervised_hits`` counts the supervised captions that name their clip's
class word.

The toy's CLAP (Cnn14 (4, 8), embed 16, batch 8) separates the classes for
only a few pretrain seeds, in the JAX package as in the port: most runs stay
at chance (loss ln 8) or give one audio embedding for every clip, and then no
captioner can name a clip's class. Which runs separate depends on the random
draws (the port's ``torch.Generator`` draws are not JAX's bits, and a card's
generator is not the CPU's) and on rounding: the JAX toy's seed 20 separates
in fp32 but not in fp64 (``tests/test_torch_toy.py --seed-stats``; ROADMAP.md
section C). The CLIs run without TF32 on a card (the toy computes in fp32, as
the JAX toy's CPU run does).

Run: python examples/end_to_end_toy_torch.py [workdir] [--device cuda|cpu]
     [--epochs PRETRAIN CAPTION SUPERVISED]   (defaults 100 100 80, the JAX toy's)
"""

import argparse
import csv
import json
import os
import subprocess
import sys
import time
import wave

import numpy as np

WORDS = ["dog", "rain", "wind", "bird", "car", "horn", "water", "park"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", ".", ",", "there", "are", "in",
         "this", "audio", "something", "sound", "a", "the"] + WORDS
EPOCHS = (100, 100, 80)        # pretrain, zero-shot captioner, supervised captioner
BATCH = 8


def synth_corpus(root: str, n: int = 24) -> str:
    """Pure tones per class; captions name the class (the JAX toy's corpus)."""
    ann = os.path.join(root, "clotho_raw", "annotation")
    aud = os.path.join(root, "clotho_raw", "audio", "dev")
    os.makedirs(ann, exist_ok=True)
    os.makedirs(aud, exist_ok=True)
    os.makedirs(os.path.join(root, "clotho_raw", "audio", "eval"), exist_ok=True)
    rows = []
    for i in range(n):
        k = i % len(WORDS)
        t = np.arange(32000 * 2) / 32000
        x = 0.3 * np.sin(2 * np.pi * 200 * (k + 1) * t)
        x += 0.01 * np.random.default_rng(i).standard_normal(len(t))
        name = f"clip_{i}.wav"
        with wave.open(os.path.join(aud, name), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(32000)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
        rows.append([name] + [f"a {WORDS[k]} sound in the audio."] * 5)
    for split in ("dev", "eval"):           # version 1 expects dev + eval
        with open(os.path.join(ann, f"{split}.csv"), "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["file_name"] + [f"caption_{j}" for j in range(1, 6)])
            w.writerows(rows)
    for name, *_ in rows:
        dst = os.path.join(root, "clotho_raw", "audio", "eval", name)
        if not os.path.exists(dst):
            os.link(os.path.join(aud, name), dst)
    return os.path.join(root, "clotho_raw")


def toy_config(root: str, epochs: int, seed: int = 20) -> dict:
    """The JAX toy's retrieval config (its seed is 20)."""
    return {
        "exp_name": "toy", "seed": seed, "embed_size": 16, "temp": 0.07,
        "embed_regularization": False, "json_files": [os.path.join(root, "pretrain.json")],
        "blacklist": None, "resume": False, "val_datasets": [],
        "data_root": root, "output_dir": os.path.join(root, "outputs"),
        "audio_channels": [4, 8],
        "audio_args": {"sr": 32000, "n_fft": 1024, "hop_length": 320, "f_min": 50,
                       "f_max": 14000, "n_mels": 64, "max_length": 2, "mono": True},
        "audio_encoder_args": {"type": "cnn", "model": "Cnn14", "pretrained": False,
                               "freeze": False},
        "data_args": {"batch_size": BATCH, "num_workers": 0},
        "text_encoder_args": {"type": "prajjwal1/bert-tiny",
                              "vocab": os.path.join(root, "bert_vocab.txt")},
        "optim_args": {"lr": 2e-3, "scheduler": "cosine", "optimizer_name": "adam",
                       "betas": [0.9, 0.999], "eps": 1e-8, "momentum": 0.9,
                       "warmup_epochs": 0, "weight_decay": 0.0},
        "training": {"spec_augmentation": False, "epochs": epochs, "clip_grad": 2,
                     "dropout": 0.2},
    }


def _paths(root: str) -> dict:
    banks = os.path.join(root, "banks")
    return {
        "prepared": os.path.join(root, "prepared"),
        "config": os.path.join(root, "config.json"),
        "banks": {s: os.path.join(banks, s, "clap_embedding", "ZS", "data.pkl")
                  for s in ("train", "val", "test")},
        "label_bank": os.path.join(root, "audioset_label.pkl"),
        "related": os.path.join(root, "train_related.pkl"),
        "caption_runs": os.path.join(root, "caption_runs"),
        "supervised_runs": os.path.join(root, "supervised_runs"),
    }


def _last_run(runs: str) -> str:
    return os.path.join(runs, sorted(os.listdir(runs))[-1])


def _run_dir(root: str, seed: int) -> str:
    return os.path.join(root, "outputs", f"toy_Cnn14_lr_0.002_seed_{seed}")


def pretrain_losses(root: str, seed: int = 20) -> list:
    """The pretrain driver's epoch losses at ``seed`` (from its log)."""
    with open(os.path.join(_run_dir(root, seed), "logging", "output.log")) as f:
        return [float(line.split("loss ")[1].split(",")[0]) for line in f if ": loss " in line]


def runner(env=None, log=print, stdout=None):
    """``run(*args)``: ``python -m *args`` in a subprocess (its output to
    ``stdout``, a file; default: this process's), logged with its wall time;
    raises if it fails."""
    env = dict(os.environ if env is None else env)
    env.setdefault("WANDB_MODE", "disabled")
    # the toy computes in fp32 (its config sets no compute_dtype), as the JAX
    # toy's CPU run does: no TF32 convolutions on a card
    env.setdefault("NVIDIA_TF32_OVERRIDE", "0")

    def run(*args):
        log("\n$ " + " ".join(args))
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", *args], env=env, stdout=stdout, check=True,
                       stderr=subprocess.STDOUT if stdout is not None else None)
        log(f"  ({args[0].rsplit('.', 1)[-1]}: {time.perf_counter() - t0:.1f} s)")

    return run


def prepare(root: str, run) -> dict:
    """Stage 1 into ``root``: the corpus, the vocabulary, ``pipeline.prepare``
    (dev stands in for train/val/test) and the pretraining manifest. Returns
    the paths of ``_paths``."""
    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    p = _paths(root)
    raw = synth_corpus(root)
    with open(os.path.join(root, "bert_vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    run("zs_aac_tpu_torch.pipeline.prepare", "clotho", raw, p["prepared"], "--version", "1")
    for split in ("train", "val", "test"):
        dst = os.path.join(p["prepared"], split)
        if not os.path.exists(dst):
            os.symlink(os.path.join(p["prepared"], "dev"), dst)
    with open(os.path.join(p["prepared"], "dev", "text.json")) as f:
        audios = json.load(f)["audios"]
    with open(os.path.join(p["prepared"], "dev", "wav.csv"), newline="") as f:
        id2f = {r["audio_id"]: r["file_name"] for r in csv.DictReader(f, delimiter="\t")}
    data = [{"audio": id2f[a["audio_id"]], "caption": a["captions"][0]["caption"],
             "id": i, "duration": 2.0} for i, a in enumerate(audios)]
    with open(os.path.join(root, "pretrain.json"), "w") as f:
        json.dump({"num_captions_per_audio": 1, "data": data}, f)
    return p


def supervised(run, train_bank: str, test_bank: str, out_dir: str, epochs: int,
               device: str) -> str:
    """Stage 8, the supervised sanity path: ``train_prompt`` on the AUDIO
    embeddings of ``train_bank`` and ``predict_prompt`` on ``test_bank``.
    Returns the run dir."""
    dev = ["--device", device]
    run("zs_aac_tpu_torch.train.train_prompt", "--data", train_bank, "--valdata", test_bank,
        "--out_dir", out_dir, "--bs", "8", "--epochs", str(epochs), "--warmup", "0",
        "--val_interval", "200", "--lr", "3e-3", "--gpt2_size", "tiny", "--prefix_length",
        "4", "--prefix_length_clip", "4", "--prefix_dim", "16", "--use_audio_embedding",
        "--normalize_prefix", *dev)
    run_dir = _last_run(out_dir)
    run("zs_aac_tpu_torch.train.predict_prompt", "--test_dir", run_dir, "--data", test_bank,
        *dev)
    return run_dir


def run_toy(root: str, device: str = "cuda", epochs=EPOCHS, env=None, log=print,
            stdout=None) -> dict:
    """Run the eight stages into ``root`` on ``device``; ``epochs`` are
    (pretrain, zero-shot captioner, supervised captioner); the CLIs write to
    ``stdout`` (a file; default: this process's). Returns the paths the
    stages wrote, with the CLAP checkpoint, its epoch losses and the two run
    dirs."""
    root = os.path.abspath(root)
    run = runner(env, log, stdout)
    dev = ["--device", device]

    # 1. prepare
    p = prepare(root, run)

    # 2. pretrain CLAP at the config's seed (the JAX toy's 20)
    config = toy_config(root, epochs[0])
    with open(p["config"], "w") as f:
        json.dump(config, f, indent=1)
    run("zs_aac_tpu_torch.train.pretrain", "-c", p["config"], *dev)
    p.update(ckpt=os.path.join(_run_dir(root, config["seed"]), "models", "best_model.ckpt"),
             pretrain_losses=pretrain_losses(root, config["seed"]))
    with open(p["config"], "w") as f:
        json.dump(dict(config, pretrain_path=p["ckpt"]), f, indent=1)

    # 3. the embedding banks
    run("zs_aac_tpu_torch.pipeline.extract", "--config", p["config"], "--dataset_path",
        p["prepared"], "--out_path", os.path.join(root, "banks"), "--batch", "8", *dev)
    # 4. an AudioSet-style label bank for the hard prompts
    labels_csv = os.path.join(root, "labels.csv")
    with open(labels_csv, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows([["display_name"]] + [[w] for w in WORDS])
    run("zs_aac_tpu_torch.pipeline.extract", "--config", p["config"], "--corpus", "audioset",
        "--text_input", labels_csv, "--out_path", p["label_bank"], *dev)

    # 5. related-caption kNN augmentation of the train bank
    run("zs_aac_tpu_torch.pipeline.related", "--input_path", p["banks"]["train"],
        "--output_path", p["related"], "--topnumber", "3", *dev)

    # 6. the zero-shot captioner, trained on TEXT embeddings
    run("zs_aac_tpu_torch.train.train_prompt", "--data", p["related"], "--valdata",
        p["banks"]["test"], "--out_dir", p["caption_runs"], "--sound_effect", p["label_bank"],
        "--bs", "8", "--epochs", str(epochs[1]), "--warmup", "0", "--val_interval", "100",
        "--lr", "3e-3", "--gpt2_size", "tiny", "--prefix_length", "4",
        "--prefix_length_clip", "4", "--noise_variance", "0.016", "--prefix_dim", "16",
        "--use_related_text", "--normalize_prefix", *dev)
    p["run_dir"] = _last_run(p["caption_runs"])

    # 7. captions from AUDIO embeddings (the zero-shot transfer), scored
    run("zs_aac_tpu_torch.train.predict_prompt", "--test_dir", p["run_dir"], "--data",
        p["banks"]["test"], "--sound_effect", p["label_bank"], "--isbeam", *dev)

    # 8. the supervised sanity path: trained on AUDIO embeddings
    p["supervised_run_dir"] = supervised(run, p["banks"]["train"], p["banks"]["test"],
                                         p["supervised_runs"], epochs[2], device)
    return p


def file_contracts(p: dict) -> list:
    """Every file the stages must have written (paths from ``run_toy``)."""
    prepared = [os.path.join(p["prepared"], s, n) for s in ("dev", "eval")
                for n in ("wav.csv", "text.json")]
    runs = [os.path.join(d, n) for d in (p["run_dir"], p["supervised_run_dir"])
            for n in ("best.pth", "output.txt", "scores.txt")]
    return (prepared + [p["ckpt"]] + list(p["banks"].values())
            + [p["label_bank"], p["related"]] + runs)


def supervised_hits(prepared: str, run_dir: str):
    """(clips whose caption in ``run_dir``'s ``output.txt`` names the clip's
    class word, clips)."""
    with open(os.path.join(prepared, "dev", "text.json")) as f:
        word = {a["audio_id"]: a["captions"][0]["caption"].split()[1]
                for a in json.load(f)["audios"]}
    with open(os.path.join(run_dir, "output.txt")) as f:
        preds = json.load(f)["predictions"]
    hits = sum(word[q["filename"]] in q["caption"].replace(".", " ").split() for q in preds)
    return hits, len(preds)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("workdir", nargs="?", default="toy_run_torch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--epochs", type=int, nargs=3, default=list(EPOCHS))
    args = ap.parse_args(argv)
    p = run_toy(args.workdir, args.device, tuple(args.epochs))
    missing = [f for f in file_contracts(p) if not os.path.exists(f)]
    if missing:
        raise SystemExit(f"missing outputs: {missing}")
    for title, d in (("supervised", p["supervised_run_dir"]), ("zero-shot", p["run_dir"])):
        print(f"\n--- {title} scores.txt ---")
        print(open(os.path.join(d, "scores.txt")).read())
        preds = json.load(open(os.path.join(d, "output.txt")))["predictions"]
        for q in preds[:4]:
            print(" ", q["filename"], "->", q["caption"][:60])
    hits, n = supervised_hits(p["prepared"], p["supervised_run_dir"])
    print(f"\npretrain: lowest epoch loss {min(p['pretrain_losses']):.4f} (chance ln {BATCH} "
          f"= {np.log(BATCH):.4f})")
    print(f"supervised captions naming their clip's class: {hits}/{n}")
    print(f"toy pipeline complete; artifacts in {os.path.abspath(args.workdir)}")


if __name__ == "__main__":
    main()
