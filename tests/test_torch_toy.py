"""The port's end-to-end toy (``examples/end_to_end_toy_torch.py``) on the
CPU, and the JAX toy's trained CLAP (``testdata/toy_clap``) through the
port's extract.

``test_toy_chain_writes_every_file_on_the_cpu`` runs the toy with every
training cut to one epoch, each stage's CLI called in process, and checks the
files each leaves (manifests, ``best_model.ckpt``, the three banks, the label bank,
the related bank, each run dir's ``best.pth``, ``output.txt`` and
``scores.txt``). Caption quality needs the full epochs and a CLAP that
separates the classes; ``chip_smoke.py`` phase 19 gates it on the card with
``toy_clap``.

Two diagnostics of the toy's CLAP, which separates the classes at few seeds
in either package (ROADMAP.md section C), run from the command line:

- ``--seed-stats [SEEDS]``: each package's own toy stages 2, 3 and 8 through
  its CLIs on the CPU (one thread each) for every seed: the lowest epoch
  loss, the audio embeddings' mean pairwise cosine and the supervised
  captions naming their class;
- ``--trajectory SEED MODE``: the toy CLAP's pretrain in process from the
  JAX package's init at ``SEED``, the epoch losses and the eval-mode audio
  embeddings' spread, for ``MODE`` one of ``jax``, ``jax64`` (the JAX step in
  fp64: the same init, batches and dropout bits), ``port`` (the port's step
  from the JAX init; its own dropout draws), ``jax-nodrop`` and
  ``port-nodrop`` (dropout off in both: the same function on the same
  inputs); ``--gradients SEED``: the first step's audio-tower gradients of
  both packages in fp32 against both in fp64.

``--write-fixture`` regenerates ``toy_clap``: the JAX toy's pretrain (its
config, seed 20, 100 epochs) through the JAX CLI, its best checkpoint as the
port's ``{"params", "batch_stats"}`` file ``clap.pt``, and ``expected.json``:
the JAX extract's audio embeddings of the 24 clips, the JAX pretrain's
lowest epoch loss and the supervised captions that the JAX stage 8 wrote
from those banks.
"""

import importlib.util
import json
import os
import pickle
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from zs_aac_tpu_torch import testdata  # noqa: E402

# the port's extract of the 24 clips on the CPU against the JAX record: fp32
# through one log-mel and a two-block CNN in another framework's kernels,
# L2-normalized (the tiny CLAP audio record's 1e-5, ``test_torch_cnn_ase``)
TOY_CLAP_TOL = 1e-5


def _toy():
    spec = importlib.util.spec_from_file_location(
        "end_to_end_toy_torch", REPO / "examples" / "end_to_end_toy_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(threads=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    if threads:
        env.update(OMP_NUM_THREADS=str(threads),
                   XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                             "intra_op_parallelism_threads=1")
    return env


def _bank_audio(path):
    """{audio_id: fp32 [embed]} of a bank's records."""
    with open(path, "rb") as f:
        return {r["audio_id"]: np.asarray(r["audio_embedding"], np.float32).reshape(-1)
                for r in pickle.load(f)}


def audio_spread(path) -> float:
    """Mean pairwise cosine of a bank's audio embeddings (1: all alike)."""
    a = np.stack(list(_bank_audio(path).values())).astype(np.float64)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    n = len(a)
    return float(((a @ a.T).sum() - n) / (n * (n - 1)))


def _in_process(env=None, log=print, stdout=None):
    """The toy's ``runner`` calling each CLI's ``main(argv)`` in this
    process: the toy's stages and files without an interpreter and torch
    started for each (the card runs them as subprocesses: ``chip_smoke.py``
    phase 19)."""
    def run(module, *args):
        log("\n$ " + " ".join((module, *args)))
        t0 = time.perf_counter()
        importlib.import_module(module).main(list(args))
        log(f"  ({module.rsplit('.', 1)[-1]}: {time.perf_counter() - t0:.1f} s)")

    return run


@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    toy = _toy()
    logged = []
    root = tmp_path_factory.mktemp("toy") / "toy"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WANDB_MODE", "disabled")
        mp.setattr(toy, "runner", _in_process)
        p = toy.run_toy(str(root), device="cpu", epochs=(1, 1, 1), log=logged.append)
    return toy, p, logged


def test_toy_chain_writes_every_file_on_the_cpu(toy_run):
    toy, p, logged = toy_run
    assert len(p["pretrain_losses"]) == 1
    assert any("(pretrain: " in line for line in logged)
    missing = [f for f in toy.file_contracts(p) if not os.path.exists(f)]
    assert not missing, missing
    with open(p["banks"]["train"], "rb") as f:
        bank = pickle.load(f)
    assert len(bank) == 24 * 5 and bank[0]["text_embedding"].shape == (1, 16)
    with open(p["label_bank"], "rb") as f:
        assert [r["label"] for r in pickle.load(f)] == toy.WORDS
    for run in (p["run_dir"], p["supervised_run_dir"]):
        preds = json.load(open(os.path.join(run, "output.txt")))["predictions"]
        assert len(preds) == 24 and "CIDEr" in open(os.path.join(run, "scores.txt")).read()
    hits, n = toy.supervised_hits(p["prepared"], p["supervised_run_dir"])
    assert n == 24 and 0 <= hits <= n
    config = json.load(open(p["config"]))
    assert config["pretrain_path"] == p["ckpt"] and config["training"]["epochs"] == 1
    assert config["seed"] == 20 and "seed_20" in p["ckpt"]


def test_toy_clap_banks_are_what_jax_extracted(toy_run, tmp_path):
    """The port's extract CLI (in process, on the CPU) with the JAX toy's
    trained CLAP gives the JAX extract's audio embeddings of the 24 clips."""
    from zs_aac_tpu_torch.pipeline import extract

    toy, p, _ = toy_run
    config = dict(toy.toy_config(str(tmp_path), 0),
                  pretrain_path=str(testdata.TOY_CLAP_DIR / "clap.pt"))
    config["text_encoder_args"]["vocab"] = os.path.join(os.path.dirname(p["prepared"]),
                                                        "bert_vocab.txt")
    with open(tmp_path / "config.json", "w") as f:
        json.dump(config, f)
    extract.main(["--config", str(tmp_path / "config.json"), "--dataset_path", p["prepared"],
                  "--splits", "test", "--out_path", str(tmp_path / "banks"), "--batch", "8",
                  "--device", "cpu"])
    got = _bank_audio(tmp_path / "banks" / "test" / "clap_embedding" / "ZS" / "data.pkl")
    want = json.loads((testdata.TOY_CLAP_DIR / "expected.json").read_text())
    assert sorted(got) == sorted(want["audio_embeddings"])
    err = max(np.abs(got[k] - np.asarray(v, np.float32)).max()
              for k, v in want["audio_embeddings"].items())
    assert err <= TOY_CLAP_TOL, err


# --- the fixture and the diagnostics (command line) -------------------------


def _jax_supervised(run, train_bank, test_bank, out_dir, epochs):
    """The JAX toy's stage 8 through the JAX CLIs (the flags of
    ``examples/end_to_end_toy.py``); returns the run dir."""
    run("zs_aac_tpu.train.train_prompt", "--data", train_bank, "--valdata", test_bank,
        "--out_dir", out_dir, "--bs", "8", "--epochs", str(epochs), "--warmup", "0",
        "--val_interval", "200", "--lr", "3e-3", "--gpt2_size", "tiny", "--prefix_length",
        "4", "--prefix_length_clip", "4", "--prefix_dim", "16", "--use_audio_embedding",
        "--normalize_prefix")
    run_dir = os.path.join(out_dir, sorted(os.listdir(out_dir))[-1])
    run("zs_aac_tpu.train.predict_prompt", "--test_dir", run_dir, "--data", test_bank)
    return run_dir


def toy_stages(package, root, seed, epochs=(100, 80), threads=1, log=print):
    """One package's toy stages 1, 2 (``seed``), 3 (the train and test
    splits) and 8 through its CLIs on the CPU. Returns (lowest epoch loss, the test bank's
    mean pairwise cosine, supervised hits, the bank's path, the checkpoint)."""
    import yaml

    toy = _toy()
    root = os.path.abspath(root)
    out = open(os.path.join(root, "stages.log"), "w")
    run = toy.runner(_env(threads), lambda s: log(f"[{package} {seed}]{s}"), out)
    p = toy.prepare(root, run)
    config = toy.toy_config(root, epochs[0], seed)
    ckpt = os.path.join(root, "outputs", f"toy_Cnn14_lr_0.002_seed_{seed}", "models",
                        "best_model.ckpt")
    if package == "jax":
        path, mod, dev = os.path.join(root, "config.yaml"), "zs_aac_tpu", []
        dump = lambda c: yaml.safe_dump(c, open(path, "w"))
    else:
        path, mod, dev = p["config"], "zs_aac_tpu_torch", ["--device", "cpu"]
        dump = lambda c: json.dump(c, open(path, "w"))
    dump(config)
    run(f"{mod}.train.pretrain", "-c", path, *dev)
    dump(dict(config, pretrain_path=ckpt))
    run(f"{mod}.pipeline.extract", "--config", path, "--dataset_path", p["prepared"],
        "--splits", "train", "test", "--out_path", os.path.join(root, "banks"), "--batch",
        "8", *dev)
    train, bank = p["banks"]["train"], p["banks"]["test"]
    if package == "jax":
        run_dir = _jax_supervised(run, train, bank, p["supervised_runs"], epochs[1])
    else:
        run_dir = toy.supervised(run, train, bank, p["supervised_runs"], epochs[1], "cpu")
    loss = min(toy.pretrain_losses(root, seed))
    return loss, audio_spread(bank), toy.supervised_hits(p["prepared"], run_dir)[0], bank, ckpt


def seed_stats(seeds, workers=8):
    """``toy_stages`` of both packages at every seed, ``workers`` at a time;
    prints a line each."""
    from concurrent.futures import ThreadPoolExecutor

    root = tempfile.mkdtemp()

    def one(job):
        package, seed = job
        d = os.path.join(root, f"{package}_{seed}")
        os.makedirs(d)
        loss, spread, hits, _, _ = toy_stages(package, d, seed, log=lambda s: None)
        line = (f"{package} seed {seed}: lowest epoch loss {loss:.4f}, audio embeddings' mean "
                f"pairwise cosine {spread:.4f}, supervised captions naming their class "
                f"{hits}/24")
        print(line, flush=True)
        return line

    with ThreadPoolExecutor(workers) as ex:
        lines = list(ex.map(one, [(pk, s) for s in seeds for pk in ("jax", "port")]))
    print("\n".join(sorted(lines)))


def _jax_init(seed, cfg, x64=False):
    """The JAX package's toy CLAP state at ``seed`` and its train step."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from zs_aac_tpu.models.ase import ASE
    from zs_aac_tpu.ops.logmel import LogMelConfig
    from zs_aac_tpu.train import optim
    from zs_aac_tpu.train.contrastive import create_ase_state, make_ase_train_step
    from zs_aac_tpu.train.contrastive import make_encode_fns
    from zs_aac_tpu.train.pretrain import build_ase_from_config

    ase, _ = build_ase_from_config(cfg)
    o, steps = cfg["optim_args"], cfg["training"]["epochs"] * 3
    opt = optax.chain(optax.clip_by_global_norm(2.0),
                      optim.get_optimizer(optim.cosine_lr(o["lr"], 0, steps), "adam",
                                          (0.9, 0.999), 1e-8, 0.9, 0.0))
    state = create_ase_state(jax.random.key(seed), ase, opt, spec_shape=(2, 101, 64))
    if x64:
        ase = ASE(dataclasses.replace(ase.cfg, dtype=jnp.float64))
        state.params = jax.tree.map(lambda t: jnp.asarray(t, jnp.float64), state.params)
        state.batch_stats = jax.tree.map(lambda t: jnp.asarray(t, jnp.float64),
                                         state.batch_stats)
        state.opt_state = opt.init(state.params)
    mel = LogMelConfig.from_dict(cfg["audio_args"])
    return ase, opt, state, jax.jit(make_ase_train_step(ase, opt, mel, mel_impl="xla")), \
        make_encode_fns(ase, mel, mel_impl="xla")[0]


def _no_dropout():
    import dataclasses

    from zs_aac_tpu.models import cnns as jcnns
    from zs_aac_tpu_torch.models import ase as tase
    from zs_aac_tpu_torch.models import cnns as tcnns

    class JaxCnn14(jcnns.Cnn14):
        dropout_rate: float = 0.0

    @dataclasses.dataclass(frozen=True)
    class TorchCnn14(tcnns.Cnn14):
        dropout_rate: float = 0.0

    jcnns.Cnn14, tase.Cnn14 = JaxCnn14, TorchCnn14


def _toy_data(seed):
    """The toy's config (``seed``), dataset, tokenizer and the 24 clips."""
    from zs_aac_tpu_torch.data.bert_tokenizer import WordPieceTokenizer
    from zs_aac_tpu_torch.data.retrieval_data import AudioLanguagePretrainDataset

    toy = _toy()
    root = tempfile.mkdtemp()
    toy.prepare(root, toy.runner(_env(), lambda s: None, open(os.devnull, "w")))
    cfg = toy.toy_config(root, 100, seed)
    data = AudioLanguagePretrainDataset(cfg["json_files"], cfg["audio_args"], None, seed)
    tok = WordPieceTokenizer.from_file(cfg["text_encoder_args"]["vocab"])
    return cfg, data, tok, np.stack([data[i][0] for i in range(len(data))]).astype(np.float32)


def trajectory(seed, mode, epochs=100):
    """The toy CLAP's pretrain from the JAX init at ``seed`` in ``mode`` (see
    the module doc): each epoch's mean loss and the eval-mode spread of the
    24 clips' audio embeddings, and the best (lowest-loss) epoch's."""
    import jax
    import jax.numpy as jnp
    import torch

    from zs_aac_tpu_torch.data.retrieval_data import pretrain_batches

    torch.set_num_threads(1)
    if mode.endswith("nodrop"):
        _no_dropout()
    if mode == "jax64":
        jax.config.update("jax_enable_x64", True)
    cfg, data, tok, waves = _toy_data(seed)
    ase, opt, state, step, encode = _jax_init(seed, cfg, x64=mode == "jax64")
    dt = jnp.float64 if mode == "jax64" else jnp.float32
    if mode.startswith("port"):
        from zs_aac_tpu_torch.models.convert import from_jax_params
        from zs_aac_tpu_torch.ops.logmel import LogMelConfig
        from zs_aac_tpu_torch.train import contrastive
        from zs_aac_tpu_torch.train.pretrain import build_ase_from_config, build_optimizer

        tase, _ = build_ase_from_config(cfg, device="cpu")
        topt = build_optimizer(cfg, len(data) // 8)
        variables = from_jax_params({"params": state.params, "batch_stats": state.batch_stats},
                                    device="cpu")
        state = contrastive.create_ase_state(seed, tase, topt, device="cpu",
                                             variables=variables)
        mel = LogMelConfig.from_dict(cfg["audio_args"])
        step = contrastive.make_ase_train_step(tase, topt, mel, device="cpu")
        enc = contrastive.make_encode_fns(tase, mel, device="cpu")[0]
        encode = lambda v, w: enc(v, torch.from_numpy(np.asarray(w, np.float32))).numpy()
    curve, spreads = [], []
    for epoch in range(epochs):
        losses = []
        for batch in pretrain_batches(data, tok, 8, seed=seed + epoch):
            batch = {k: v for k, v in batch.items() if k != "text"}
            if mode.startswith("port"):
                state, loss = step(state, batch, seed + 1)
            else:
                batch = {k: jnp.asarray(v, dt if k == "wave" else None) for k, v in batch.items()}
                state, loss = step(state, batch, jax.random.key(seed + 1))
            losses.append(float(loss))
        curve.append(float(np.mean(losses)))
        a = np.array(encode({"params": state.params, "batch_stats": state.batch_stats},
                            jnp.asarray(waves, dt) if not mode.startswith("port") else waves),
                     np.float64)
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        spreads.append(float(((a @ a.T).sum() - len(a)) / (len(a) * (len(a) - 1))))
    best = int(np.argmin(curve))
    print(f"{mode} seed {seed}: best epoch {best}, loss {curve[best]:.4f}, spread "
          f"{spreads[best]:.4f}; every 10th epoch (loss/spread): "
          + " ".join(f"{c:.3f}/{s:.3f}" for c, s in zip(curve[::10], spreads[::10])),
          flush=True)
    return curve, spreads


def gradients(seed):
    """The first step's audio-tower gradients: JAX fp32, the port fp32 and
    JAX fp64, each against the port in fp64 (dropout off, one log-mel)."""
    import dataclasses

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from zs_aac_tpu.models.ase import ASE as JASE
    from zs_aac_tpu_torch.data.retrieval_data import pretrain_batches
    from zs_aac_tpu_torch.models.ase import ASE as TASE
    from zs_aac_tpu_torch.models.convert import from_jax_params, tree_map
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig, log_mel
    from zs_aac_tpu_torch.train.optim import tree_leaves
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config

    _no_dropout()
    cfg, data, tok, _ = _toy_data(seed)
    jase, _, state, _, _ = _jax_init(seed, cfg)
    tase, _ = build_ase_from_config(cfg, device="cpu")
    batch = next(iter(pretrain_batches(data, tok, 8, seed=seed)))
    spec = log_mel(torch.as_tensor(batch["wave"]), LogMelConfig.from_dict(cfg["audio_args"]))
    spec = spec[:, 0].numpy()
    ids, mask, idx = (batch[k] for k in ("input_ids", "attention_mask", "idx"))

    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{pre}/{k}") if isinstance(v, dict)
                       else {f"{pre}/{k}": np.asarray(v, np.float64)})
        return out

    def jax_grads(dt):
        m = JASE(dataclasses.replace(jase.cfg, dtype=dt))
        stats = jax.tree.map(lambda t: jnp.asarray(t, dt), state.batch_stats)

        def loss(pp):
            return m.apply({"params": pp, "batch_stats": stats}, jnp.asarray(spec, dt), ids,
                           mask, idx, train=True, mutable=["batch_stats"],
                           rngs={"specaug": jax.random.key(0), "dropout": jax.random.key(1)})[0]

        g = jax.grad(loss)(jax.tree.map(lambda t: jnp.asarray(t, dt), state.params))
        return flat(from_jax_params({"params": jax.tree.map(np.asarray, g)},
                                    device="cpu")["params"]["audio_enc"])

    def port_grads(dt):
        m = TASE(dataclasses.replace(tase.cfg, dtype=dt))
        v = from_jax_params({"params": state.params, "batch_stats": state.batch_stats},
                            device="cpu")
        params = tree_map(lambda t: t.to(dt).requires_grad_(), v["params"])
        stats = tree_map(lambda t: t.to(dt), v["batch_stats"])
        loss, _ = m({"params": params, "batch_stats": stats}, torch.as_tensor(spec).to(dt),
                    *(torch.as_tensor(x) for x in (ids, mask, idx)), train=True,
                    generator=torch.Generator().manual_seed(0))
        leaves = tree_leaves(params["audio_enc"])
        it = iter(torch.autograd.grad(loss, leaves))
        return flat(tree_map(lambda _: next(it).detach().double(), params["audio_enc"]))

    ref = port_grads(torch.float64)
    runs = {"jax fp32": jax_grads(jnp.float32), "port fp32": port_grads(torch.float32),
            "jax fp64": jax_grads(jnp.float64)}
    for k in sorted(ref):
        scale = np.abs(ref[k]).max()
        print(f"{k:24s} max|g| {scale:.2e}; max|g - port fp64| / max|g|: " + ", ".join(
            f"{n} {np.abs(g[k] - ref[k]).max() / scale:.1e}" for n, g in runs.items()))


def write_fixture():
    """``testdata/toy_clap``: the JAX toy's pretrain (seed 20, 100 epochs),
    its banks and its stage 8, all through the JAX CLIs on the CPU."""
    import jax
    import torch

    from zs_aac_tpu.train.contrastive import create_ase_state
    from zs_aac_tpu.train.optim import cosine_lr, get_optimizer
    from zs_aac_tpu.train.pretrain import build_ase_from_config
    from zs_aac_tpu.utils.checkpoints import restore_model_only
    from zs_aac_tpu_torch.models.convert import from_jax_params

    root = tempfile.mkdtemp()
    loss, spread, hits, bank, ckpt = toy_stages("jax", root, 20, threads=None)
    config = _toy().toy_config(root, 100)
    ase, _ = build_ase_from_config(config)
    state = create_ase_state(jax.random.key(0), ase, get_optimizer(cosine_lr(1e-4, 1, 10)),
                             spec_shape=(2, 101, 64))
    state = restore_model_only(ckpt, state)
    variables = from_jax_params({"params": state.params, "batch_stats": state.batch_stats},
                                device="cpu")
    # keep the word-embedding rows the toy's vocabulary indexes (23 of
    # bert-tiny's 30,522, the rest never trained nor read): 1.9 MB, not 17.5
    emb = variables["params"]["text_enc"]["word_embeddings"]
    emb["embedding"] = emb["embedding"][:len(_toy().VOCAB)].clone()
    out = testdata.TOY_CLAP_DIR
    out.mkdir(exist_ok=True)
    torch.save(variables, out / "clap.pt")
    record = {"seed": 20, "pretrain_epochs": 100, "lowest_epoch_loss": loss,
              "audio_spread": spread, "supervised_hits": hits,
              "audio_embeddings": {k: [float(x) for x in v]
                                   for k, v in sorted(_bank_audio(bank).items())}}
    (out / "expected.json").write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {out}: lowest epoch loss {loss:.4f}, spread {spread:.4f}, "
          f"supervised hits {hits}/24")


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    args = sys.argv[1:]
    if args[:1] == ["--seed-stats"]:
        seed_stats([int(s) for s in args[1:]] or list(range(20, 32)))
    elif args[:1] == ["--trajectory"] and len(args) == 3:
        trajectory(int(args[1]), args[2])
    elif args[:1] == ["--gradients"] and len(args) == 2:
        gradients(int(args[1]))
    elif args == ["--write-fixture"]:
        write_fixture()
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_toy.py --seed-stats [SEEDS] | "
                 "--trajectory SEED jax|jax64|port|jax-nodrop|port-nodrop | --gradients SEED "
                 "| --write-fixture")
