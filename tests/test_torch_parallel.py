"""The port's multi-GPU paths (``zs_aac_tpu_torch/parallel``) on the CPU, over
gloo, held to one process and to the JAX package.

The JAX package's sharded runs compute its unsharded functions (GSPMD), so
each multi-process run here is held to the one-process run of the same
global batch and, where the JAX package has the function, to the JAX run.
The processes are started by ``parallel.dryrun.spawn`` (``torch.
multiprocessing``, spawn); one start at world size 2 serves the tests of
the ``world2`` fixture, and the dryrun starts its own four.

- Pure helpers in one process: ``local_batch_slice`` and the data's local
  slices and strided evaluation batches (``tests/test_multihost.py``'s
  cases; a capped evaluation the same rows at any world size),
  ``_reassemble``, ``allgather_by_index``, ``make_mesh`` without a group,
  ``make_mesh_for_batch`` raising on a batch the world does not divide,
  and the Megatron shard layout (``c_attn`` by heads).
- The ASE step at world 2: the committed tiny ASE's three recorded steps
  (draws off, Adam) against the JAX-recorded run (the fixture's bounds) and
  against world 1 (losses 1e-5 relative, parameters 1e-4 of each leaf's
  size plus 1e-7, a unit parameter's fp32 rounding, for the leaves whose
  exact gradient is zero and whose values are rounding noise, batch
  statistics 1e-5 relative / 1e-6 absolute); with SpecAugment
  and dropout (Cnn14) or drop path (HTSAT) on, two SGD steps against world
  1 at the same bounds, and the first step's gradient ((p0 - p1) / lr)
  within 1e-4 of each leaf's largest gradient, so a gradient that is the
  world size times too large fails. The JAX comparison runs with the draws
  off: the port's draws are not ``jax.random``'s bits.
- GPT-2 tp2 greedy and beam, and Mistral tp2 greedy with LoRA: tokens and
  lengths equal to the JAX package's unsharded decode (and, for GPT-2, its
  tp2 decode on the 4 x 2 mesh of ``tests/conftest.py``); an odd
  vocabulary (padded over the group) decodes as one process does.
- ``attach_related`` at world 2 (exact ties across the two ranks' blocks)
  equals world 1; ``allgather_by_index`` with unequal counts.
- ``pretrain``/``finetune`` at world 2 (SGD): the saved checkpoints equal
  world 1's (parameters 1e-5 relative and absolute, batch statistics 1e-5
  relative / 1e-6 absolute) and the logged recalls equal world 1's (a
  capped validation covers the same rows at any world size). The toy's
  clips are not cropped: crops are drawn from ``seed + rank`` in each
  rank's load order, so a cropped run at world 2 differs from world 1;
  ``train_prompt --data_parallel`` at world 2: ``last.pth`` within 1e-5 of
  world 1's.
- The dryrun (``python -m zs_aac_tpu_torch.parallel.dryrun --nproc 4
  --device cpu``): its four runs within their bounds of one process, the
  trained parameters moved by more than 100 times the bound.

Nothing at the top of this file imports JAX: the spawned processes import
it to find their worker functions.
"""

import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

from zs_aac_tpu_torch import testdata
from zs_aac_tpu_torch.parallel import mesh as pmesh
from zs_aac_tpu_torch.parallel import tp as ptp
from zs_aac_tpu_torch.parallel.dryrun import spawn

torch.set_num_threads(2)

CPU = torch.device("cpu")
GPT2_CFG = dict(vocab_size=50, n_positions=96, n_embd=32, n_layer=2, n_head=4)  # test_decoding
MISTRAL_CFG = dict(vocab_size=120, hidden_size=32, n_layers=2, n_heads=4, n_kv_heads=2,
                   intermediate_size=64, sliding_window=64, max_positions=64)  # test_mistral
STOP = 7
SGD_LR = 0.1


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _flat(tree, prefix=""):
    """{path: numpy} of a nested dict of tensors or arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return out


# ---------------------------------------------------------------------------
# Work of one process (world 1 here, or a rank of the world-2 start)
# ---------------------------------------------------------------------------


def _ase_fixture_run(dev, mesh, batch):
    """The committed tiny ASE's recorded run on ``batch`` (its
    ``testdata.train_batch()``): three steps, draws off."""
    from zs_aac_tpu_torch.models.convert import convert_ase
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import create_ase_state, make_ase_train_step
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config

    config = json.loads((testdata.TINY_ASE_DIR / "config.json").read_text())
    ase, cfg = build_ase_from_config(config, device=dev)
    sd = torch.load(testdata.TINY_ASE_DIR / "ase.pt", map_location="cpu", weights_only=True)
    opt = testdata.train_optimizer()
    state = create_ase_state(0, ase, opt, device=dev, variables=convert_ase(sd, cfg, device=dev))
    step = make_ase_train_step(ase, opt, LogMelConfig.from_dict(config["audio_args"]),
                               device=dev, mesh=mesh)
    batch = pmesh.shard_batch(batch, mesh)
    losses = []
    for _ in range(testdata.TRAIN_STEPS):
        state, loss = step(state, batch, 0)
        losses.append(loss.item())
    return {"losses": losses, "params": _flat(state.params),
            "batch_stats": _flat(state.batch_stats)}


def _ase_draws_run(dev, mesh, tower, batch):
    """Two SGD steps with SpecAugment and dropout (Cnn14) or drop path
    (HTSAT) on: the parameters before and after each, and the losses."""
    from zs_aac_tpu_torch.models.ase import ASE, ASEConfig
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import create_ase_state, make_ase_train_step
    from zs_aac_tpu_torch.train.optim import get_optimizer

    config = json.loads((testdata.TINY_ASE_DIR / "config.json").read_text())
    if tower == "cnn14":
        cfg = ASEConfig(embed_size=32, audio_channels=(8, 16), text_model="bert-tiny-test",
                        spec_augmentation=True, n_mels=16)
    else:
        kw = {**config["htsat_kwargs"], "spec_augmentation": True, "drop_path_rate": 0.2}
        cfg = ASEConfig(embed_size=32, audio_encoder="htsat", text_model="bert-tiny-test",
                        spec_augmentation=True, n_mels=16,
                        htsat_kwargs=tuple((k, tuple(v) if isinstance(v, list) else v)
                                           for k, v in kw.items()))
    ase = ASE(cfg)
    opt = get_optimizer(lambda step: SGD_LR, "sgd")
    state = create_ase_state(3, ase, opt, device=dev)
    step = make_ase_train_step(ase, opt, LogMelConfig.from_dict(config["audio_args"]),
                               device=dev, mesh=mesh)
    batch = pmesh.shard_batch(batch, mesh)
    params, losses = [_flat(state.params)], []
    for _ in range(2):
        state, loss = step(state, batch, 4)
        losses.append(loss.item())
        params.append(_flat(state.params))
    return {"losses": losses, "params": params, "batch_stats": _flat(state.batch_stats)}


def _gpt2_decodes(dev, tp, params_np, prefix, vocab_size):
    from zs_aac_tpu_torch.decoding.beam import beam_search_batched
    from zs_aac_tpu_torch.decoding.greedy import greedy_decode
    from zs_aac_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config(**{**GPT2_CFG, "vocab_size": vocab_size})
    params = _to_torch(params_np)
    if tp is not None:
        params = ptp.shard_gpt2_params(params, cfg, tp)
    emb = torch.from_numpy(prefix).to(dev)
    t, ln = greedy_decode(params, cfg, emb, 12, STOP, 764, tp=tp)
    bt, bl, _ = beam_search_batched(params, cfg, emb, 3, 10, STOP, tp=tp)
    return {"greedy": (t.numpy(), ln.numpy()), "beam": (bt.numpy(), bl.numpy())}


def _mistral_decode(dev, tp, params_np, lora_np, emb):
    from zs_aac_tpu_torch.decoding.greedy import mistral_greedy_decode
    from zs_aac_tpu_torch.models.mistral import MistralConfig

    cfg = MistralConfig(**MISTRAL_CFG)
    params, lora = _to_torch(params_np), _to_torch(lora_np)
    if tp is not None:
        params = ptp.shard_mistral_params(params, cfg, tp)
        lora = ptp.shard_mistral_lora(lora, cfg, tp)
    t, ln = mistral_greedy_decode(params, cfg, torch.from_numpy(emb).to(dev), lora, 8, 2, tp=tp)
    return t.numpy(), ln.numpy()


def _related(dev, mesh, bank, records):
    from zs_aac_tpu_torch.pipeline.related import attach_related

    out = list(attach_related(bank, records, 5, batch=4, device=dev, mesh=mesh))
    return np.stack([r["related_embeddings"] for r in out])


def _retrieval_drivers(dev, config):
    from zs_aac_tpu_torch.train import finetune, pretrain

    pre = pretrain.run(config, device=dev, max_steps=2, max_val_batches=2)
    fine = finetune.run(config, "Toy", device=dev, max_steps=2, max_val_batches=2)
    return pre, fine


def _world2_worker(dev, job):
    """One rank of the world-2 start: every multi-process case of the
    ``world2`` fixture, in turn."""
    data = pmesh.make_mesh(2, 1)
    model = pmesh.make_mesh(1, 2)
    tp = pmesh.mesh_axis(model, "model")
    batch = job["train_batch"]
    out = {"axes": (pmesh.tensor_axis(data), pmesh.tensor_axis(model).size, tp.size,
                    pmesh.mesh_axis(data, "data").size, pmesh.mesh_axis(data, "data").rank),
           "ase_fixture": _ase_fixture_run(dev, data, batch),
           "ase_draws": {t: _ase_draws_run(dev, data, t, batch) for t in ("cnn14", "htsat")},
           "gpt2": _gpt2_decodes(dev, tp, job["gpt2"], job["prefix"], GPT2_CFG["vocab_size"]),
           "gpt2_odd": _gpt2_decodes(dev, tp, job["gpt2_odd"], job["prefix"], 51),
           "mistral": _mistral_decode(dev, tp, job["mistral"], job["lora"], job["emb"]),
           "related": _related(dev, data, job["bank"], job["records"])}
    index = [np.asarray([3, 1]), np.asarray([0, 2, 4])][pmesh.process_index()]
    out["allgather"] = pmesh.allgather_by_index(index, index[:, None] * 10.0)
    out["drivers"] = _retrieval_drivers(dev, job["retrieval_config"])
    from zs_aac_tpu_torch.train.train_prompt import main as train_prompt

    out["train_prompt"] = train_prompt(job["train_prompt_args"])   # leaves the group
    return out


# ---------------------------------------------------------------------------
# Pure helpers (one process)
# ---------------------------------------------------------------------------


def _mock_procs(monkeypatch, count, index):
    from zs_aac_tpu_torch.data import retrieval_data

    for mod in (pmesh, retrieval_data):
        monkeypatch.setattr(mod, "process_count", lambda: count)
        monkeypatch.setattr(mod, "process_index", lambda: index)


class _StubTokenizer:
    def batch_encode(self, texts, max_length, pad_to_max=True):
        ids = np.ones((len(texts), max_length), np.int64)
        return ids, np.ones_like(ids)


class _FakeDataset:
    sr = 16

    def __init__(self, n):
        rng = np.random.default_rng(0)
        self.lengths = list(rng.uniform(1, 20, n))
        self._waves = [np.zeros(int(s * 16), np.float32) for s in self.lengths]

    def __len__(self):
        return len(self._waves)

    def __getitem__(self, i):
        return self._waves[i], f"caption {i}", i


def test_local_batch_slices_are_disjoint_and_shape_consistent(monkeypatch):
    """``pretrain_batches``: each process its slice of every global batch, one
    shape for all (the global batch's bucket); an uneven batch raises."""
    from zs_aac_tpu_torch.data.retrieval_data import pretrain_batches

    def collect(count, index):
        _mock_procs(monkeypatch, count, index)
        return list(pretrain_batches(_FakeDataset(32), _StubTokenizer(), batch_size=8, seed=3))

    single, host0, host1 = collect(1, 0), collect(2, 0), collect(2, 1)
    assert len(single) == len(host0) == len(host1) > 0
    for full, a, b in zip(single, host0, host1):
        assert a["wave"].shape == b["wave"].shape == (4, full["wave"].shape[1])
        assert list(a["idx"]) + list(b["idx"]) == list(full["idx"])
    _mock_procs(monkeypatch, 3, 0)
    with pytest.raises(ValueError, match="divisible"):
        pmesh.local_batch_slice(8)


def test_data_module_batches_split_rows_and_stride_evaluation(monkeypatch):
    """Evaluation batches: every process a disjoint set of whole batches,
    tagged with global row ids. Training batches: each global batch split
    by rows, together the one-process batch."""
    from zs_aac_tpu_torch.data.retrieval_data import AudioCaptionDataModule

    dm = AudioCaptionDataModule.__new__(AudioCaptionDataModule)
    dm.batch_size, dm.text_len, dm.pad_samples = 4, 8, 16
    dm.tokenizer = _StubTokenizer()

    class _DS:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            return np.zeros(8, np.float32), f"c {i}", i

    seen = {}
    for index in (0, 1, 2):
        _mock_procs(monkeypatch, 3, index)
        for batch in dm._batches(_DS(), shuffle=False):
            for g in batch["index"]:
                assert int(g) not in seen, "row assigned to two processes"
                seen[int(g)] = index
    assert sorted(seen) == list(range(12))
    _mock_procs(monkeypatch, 1, 0)
    whole = [list(b["index"]) for b in dm._batches(_DS(), True, seed=5, drop_last=True)]
    parts = []
    for index in (0, 1):
        _mock_procs(monkeypatch, 2, index)
        parts.append([list(b["index"]) for b in dm._batches(_DS(), True, seed=5,
                                                             drop_last=True)])
    assert [a + b for a, b in zip(*parts)] == whole


def test_reassemble_handles_padding_and_order():
    gi = np.asarray([[3, 1, -1], [0, 2, 4]])
    ga = np.asarray([[[30.0], [10.0], [0.0]], [[0.0], [20.0], [40.0]]])
    (out,) = pmesh._reassemble(gi, [ga])
    np.testing.assert_allclose(out[:, 0], [0.0, 10.0, 20.0, 30.0, 40.0])


def test_allgather_by_index_single_process_sorts():
    ga, gb = pmesh.allgather_by_index(np.asarray([2, 0, 1]), np.asarray([[2.0], [0.0], [1.0]]),
                                      np.asarray([20, 0, 10]))
    np.testing.assert_allclose(ga[:, 0], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(gb, [0, 10, 20])


def test_mesh_helpers_without_a_process_group():
    """One process, no group: the 1 x 1 mesh is the single-process path
    (None, every collective the identity), a larger one raises, and an
    uneven split of rows raises."""
    assert pmesh.process_count() == 1 and pmesh.is_main_process()
    assert pmesh.make_mesh() is None and pmesh.make_mesh_for_batch(6) is None
    with pytest.raises(RuntimeError, match="torchrun"):
        pmesh.make_mesh(2, 1)
    assert pmesh.mesh_axis(None, "data") is None and pmesh.tensor_axis(None) is None
    x = torch.arange(6.0)
    for f in (pmesh.gather_rows, pmesh.mean_over, pmesh.tp_copy, pmesh.tp_reduce,
              pmesh.tp_gather, pmesh.all_sum):
        assert f(x, None) is x
    assert pmesh.shard_batch({"a": np.arange(4)}, None)["a"].tolist() == [0, 1, 2, 3]
    axis = pmesh.Axis(None, 1, 2)
    assert axis.rows(6) == slice(3, 6) and axis.local(x).tolist() == [3.0, 4.0, 5.0]
    with pytest.raises(ValueError, match="evenly"):
        axis.rows(5)


def test_mesh_for_a_batch_the_world_does_not_divide_raises(monkeypatch):
    _mock_procs(monkeypatch, 4, 0)
    with pytest.raises(ValueError, match="divisible by process_count 4"):
        pmesh.make_mesh_for_batch(6)


def test_capped_evaluation_covers_the_same_rows_at_any_world_size(monkeypatch):
    """``max_batches`` caps the global evaluation batches before they are
    strided over the processes."""
    from zs_aac_tpu_torch.data.retrieval_data import AudioCaptionDataModule

    dm = AudioCaptionDataModule.__new__(AudioCaptionDataModule)
    dm.batch_size, dm.text_len, dm.pad_samples = 4, 8, 16
    dm.tokenizer = _StubTokenizer()

    class _DS:
        def __len__(self):
            return 20

        def __getitem__(self, i):
            return np.zeros(8, np.float32), f"c {i}", i

    for world in (1, 2, 3):
        rows = []
        for index in range(world):
            _mock_procs(monkeypatch, world, index)
            rows += [int(g) for b in dm._batches(_DS(), False, max_batches=3)
                     for g in b["index"]]
        assert sorted(rows) == list(range(12)), world


def test_shard_layouts_split_by_heads():
    """Rank r of a tp2 GPT-2 shard holds heads 2r, 2r+1 of each of q, k and
    v (not a contiguous half of the fused ``c_attn``), row blocks of both
    ``c_proj`` with their biases whole, and vocabulary rows padded to the
    group; the Mistral shard refuses the fused serving leaves, int8
    weights and a kv-head count the group does not divide, and the Mistral
    forward and prefill refuse the fused leaves and the int8 cache under
    ``tp``."""
    from zs_aac_tpu_torch.models.gpt2 import GPT2Config, init_gpt2
    from zs_aac_tpu_torch.models.mistral import MistralConfig, init_mistral, quantize_mistral_int8

    cfg = GPT2Config(**{**GPT2_CFG, "vocab_size": 51})
    full = init_gpt2(cfg, 0, "cpu")
    D, d = cfg.n_embd, cfg.n_embd // cfg.n_head
    for r in (0, 1):
        s = ptp.shard_gpt2_params(full, cfg, pmesh.Axis(None, r, 2))
        w = full["h"][0]["attn"]["c_attn"]["w"]
        cols = torch.cat([torch.arange(j * D + r * 2 * d, j * D + (r + 1) * 2 * d)
                          for j in range(3)])
        torch.testing.assert_close(s["h"][0]["attn"]["c_attn"]["w"], w[:, cols], rtol=0, atol=0)
        torch.testing.assert_close(s["h"][0]["attn"]["c_proj"]["w"],
                                   full["h"][0]["attn"]["c_proj"]["w"][r * D // 2:(r + 1) * D // 2],
                                   rtol=0, atol=0)
        assert s["h"][0]["mlp"]["c_proj"]["b"] is full["h"][0]["mlp"]["c_proj"]["b"]
        assert s["wte"].shape == (26, D)
    assert not s["wte"][-1].any()        # the padding row
    mcfg = MistralConfig(**MISTRAL_CFG)
    base = init_mistral(mcfg, 0, "cpu", torch.float32)
    with pytest.raises(ValueError, match="fused"):
        ptp.shard_mistral_params(quantize_mistral_int8(base, "w8", fuse=True), mcfg,
                                 pmesh.Axis(None, 0, 2))
    with pytest.raises(ValueError, match="float"):
        ptp.shard_mistral_params(quantize_mistral_int8(base, "w8"), mcfg, pmesh.Axis(None, 0, 2))
    with pytest.raises(ValueError, match="n_kv_heads"):
        ptp.shard_mistral_params(base, mcfg, pmesh.Axis(None, 0, 4))
    # the models refuse the fused leaves and the int8 cache under tp
    from zs_aac_tpu_torch.models.mistral import (init_mistral_cache_q8, mistral_forward,
                                                 mistral_prefill)

    one = pmesh.Axis(None, 0, 1)
    emb = torch.zeros(1, 3, mcfg.hidden_size)
    with pytest.raises(ValueError, match="fused"):
        mistral_forward(quantize_mistral_int8(base, "w8", fuse=True), mcfg, emb, tp=one)
    with pytest.raises(ValueError, match="int8 KV cache"):
        mistral_prefill(base, mcfg, emb, init_mistral_cache_q8(mcfg, 1, 4, "cpu"), tp=one)


# ---------------------------------------------------------------------------
# World size 2
# ---------------------------------------------------------------------------


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.numpy()


def _jax_references(job):
    """The weights (the port's seeded init, the JAX pytree's layout) and the
    JAX package's decodes of them: GPT-2 greedy and beam unsharded and tp2
    on the 4 x 2 mesh, Mistral greedy with LoRA unsharded."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from zs_aac_tpu.decoding.beam import beam_search_batched
    from zs_aac_tpu.decoding.greedy import greedy_decode, mistral_greedy_decode
    from zs_aac_tpu.models import mistral as jm
    from zs_aac_tpu.models.gpt2 import GPT2Config
    from zs_aac_tpu.parallel.tp import shard_gpt2_params
    from zs_aac_tpu_torch.models import gpt2 as tg
    from zs_aac_tpu_torch.models import mistral as tm

    job["gpt2"] = _np(tg.init_gpt2(tg.GPT2Config(**GPT2_CFG), 9, "cpu"))
    job["gpt2_odd"] = _np(tg.init_gpt2(tg.GPT2Config(**{**GPT2_CFG, "vocab_size": 51}), 10,
                                       "cpu"))
    tcfg = tm.MistralConfig(**MISTRAL_CFG)
    job["mistral"] = _np(tm.init_mistral(tcfg, 0, "cpu", torch.float32))
    rng = np.random.default_rng(2)
    job["lora"] = jax.tree.map(lambda x: (rng.standard_normal(x.shape).astype(np.float32)
                                          * 0.05) if x.ndim == 2 else x,
                               _np(tm.init_lora(tcfg, 2, 4, 1, "cpu")))

    cfg = GPT2Config(**GPT2_CFG)
    params = jax.tree.map(jnp.asarray, job["gpt2"])
    prefix = jnp.asarray(job["prefix"])
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
    ref = {}
    for name, p in (("unsharded", params), ("tp2", shard_gpt2_params(params, mesh))):
        ref[name] = {"greedy": tuple(map(np.asarray, greedy_decode(p, cfg, prefix, 12, STOP, 764))),
                     "beam": tuple(map(np.asarray,
                                       beam_search_batched(p, cfg, prefix, 3, 10, STOP)[:2]))}
    ref["mistral"] = tuple(map(np.asarray, mistral_greedy_decode(
        jax.tree.map(jnp.asarray, job["mistral"]), jm.MistralConfig(**MISTRAL_CFG),
        jnp.asarray(job["emb"]), jax.tree.map(jnp.asarray, job["lora"]), 8, 2)))
    return ref


def _retrieval_config(root, vocab, out):
    from test_torch_pretrain import _config

    config = _config(root, vocab)
    config["output_dir"] = out
    # clips of 2-8 s, none cropped: the crops draw from ``seed + rank``
    config["audio_args"]["max_length"] = 10
    # SGD: Adam turns the rounding noise of the exactly-zero gradients of the
    # attention key biases into steps of the learning rate
    config["optim_args"]["optimizer_name"] = "sgd"
    return config


def _caption_banks(root):
    from test_torch_train_prompt import CAPTIONS, _cluster

    r = np.random.default_rng(0)
    train = [{"audio_id": f"train{i}", "caption": CAPTIONS[i % 4],
              "text_embedding": _cluster(r, i % 4), "audio_embedding": _cluster(r, i % 4)}
             for i in range(32)]
    test = [{"audio_id": f"clip{i}", "audio_embedding": _cluster(r, i % 4),
             "caption": [{"caption": CAPTIONS[i % 4]}]} for i in range(4)]
    paths = {k: str(root / f"{k}.pkl") for k in ("train", "test")}
    for k, recs in (("train", train), ("test", test)):
        with open(paths[k], "wb") as f:
            pickle.dump(recs, f)
    return paths


def _train_prompt_args(banks, out_dir, *extra):
    from test_torch_train_prompt import _driver_args

    return _driver_args(banks, out_dir, "--device", "cpu", "--max_iters", "3",
                        "--noise_variance", "0.016", "--val_interval", "100", *extra)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every world-2 case in one start of two processes, beside the same
    cases in this process (world 1) and the JAX references."""
    from test_retrieval_pipeline import _mk_corpus

    os.environ["WANDB_MODE"] = "disabled"
    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(9)
    bank = rng.standard_normal((37, 8)).astype(np.float32)
    bank[30] = bank[3]                       # an exact tie across the two ranks' blocks
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    records = [{"text_embedding": bank[3] + 0.01 * rng.standard_normal(8).astype(np.float32)}
               ] + [{"text_embedding": rng.standard_normal(8).astype(np.float32)}
                    for _ in range(8)]
    job = {"prefix": np.random.default_rng(9).standard_normal((2, 4, 32)).astype(np.float32),
           "emb": (np.random.default_rng(0).standard_normal((2, 5, 32)) * 0.1).astype(np.float32),
           "bank": bank, "records": records, "train_batch": testdata.train_batch()}
    jax_ref = _jax_references(job)
    vocab = _mk_corpus(str(root), n_audio=8)
    banks = _caption_banks(root)
    job["retrieval_config"] = _retrieval_config(str(root), vocab, str(root / "world2"))
    job["train_prompt_args"] = _train_prompt_args(banks, str(root / "tp_world2"),
                                                  "--data_parallel")
    multi = spawn(_world2_worker, 2, job, threads=2)

    from zs_aac_tpu_torch.train.train_prompt import main as train_prompt

    batch = job["train_batch"]
    one = {"ase_fixture": _ase_fixture_run(CPU, None, batch),
           "ase_draws": {t: _ase_draws_run(CPU, None, t, batch) for t in ("cnn14", "htsat")},
           "gpt2_odd": _gpt2_decodes(CPU, None, job["gpt2_odd"], job["prefix"], 51),
           "related": _related(CPU, None, bank, records),
           "drivers": _retrieval_drivers(CPU, _retrieval_config(str(root), vocab,
                                                                str(root / "world1"))),
           "train_prompt": train_prompt(_train_prompt_args(banks, str(root / "tp_world1"),
                                                           "--data_parallel"))}
    return {"multi": multi, "one": one, "jax": jax_ref, "bank": bank, "records": records,
            "out": {w: str(root / w) for w in ("world1", "world2")}}


def _assert_ase_close(got, want, loss_rtol=1e-5):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=loss_rtol)
    params = [(got["params"], want["params"])] if isinstance(got["params"], dict) else list(
        zip(got["params"], want["params"]))
    for g, w in params:
        assert sorted(g) == sorted(w)
        for k in w:
            scale = np.abs(w[k]).max() + 1e-12
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4 * scale + 1e-7, err_msg=k)
    for k in want["batch_stats"]:
        np.testing.assert_allclose(got["batch_stats"][k], want["batch_stats"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_ase_step_world2_matches_world1_and_jax(world2):
    """The recorded tiny-ASE run at world 2: both ranks end with one state,
    within the bounds of world 1, and within the committed fixture's bounds
    of the JAX package's ``make_ase_train_step`` (its recorded run)."""
    got = [m["ase_fixture"] for m in world2["multi"]]
    _assert_ase_close(got[0], world2["one"]["ase_fixture"])
    _assert_ase_close(got[1], got[0], loss_rtol=0)
    want = json.loads((testdata.TINY_ASE_DIR / "train_expected.json").read_text())
    params = {}
    for k, v in got[0]["params"].items():
        node = params
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    replay = {"losses": got[0]["losses"], "checksums": testdata.checksums(params),
              "batch_stats": {k.split("/")[-1]: v for k, v in got[0]["batch_stats"].items()
                              if k.startswith("audio_enc/bn0/")}}
    err = testdata.train_fixture_errors(replay, want)
    assert err["loss"] < 1e-4 and err["params"] < 1e-4 and err["batch_stats"] < 1e-5, err


@pytest.mark.parametrize("tower", ["cnn14", "htsat"])
def test_ase_step_world2_with_draws_matches_world1(world2, tower):
    """SpecAugment and dropout / drop path drawn for the global batch: two
    SGD steps at world 2 equal world 1's, and so does the first step's
    gradient, leaf by leaf (a world-times gradient is off by 100%)."""
    got, want = world2["multi"][0]["ase_draws"][tower], world2["one"]["ase_draws"][tower]
    _assert_ase_close(got, want)
    g0, w0 = got["params"], want["params"]
    moved = 0.0
    for k in w0[0]:
        grad_w = (w0[0][k] - w0[1][k]) / SGD_LR
        grad_g = (g0[0][k] - g0[1][k]) / SGD_LR
        top = np.abs(grad_w).max()
        np.testing.assert_allclose(grad_g, grad_w, rtol=0, atol=1e-4 * top + 1e-6, err_msg=k)
        moved = max(moved, top)
    assert moved > 1e-2
    assert got["losses"][1] != got["losses"][0]


def test_gpt2_tp2_greedy_and_beam_match_jax(world2):
    for m in world2["multi"]:
        got = m["gpt2"]
        for ref in ("unsharded", "tp2"):
            want = world2["jax"][ref]
            for mode in ("greedy", "beam"):
                for a, b in zip(got[mode], want[mode]):
                    np.testing.assert_array_equal(a, b, err_msg=f"{mode} vs JAX {ref}")


def test_gpt2_tp2_pads_an_odd_vocabulary(world2):
    """Vocabulary 51 over two ranks (one zero row of padding): the tokens of
    one process."""
    for m in world2["multi"]:
        for mode in ("greedy", "beam"):
            for a, b in zip(m["gpt2_odd"][mode], world2["one"]["gpt2_odd"][mode]):
                np.testing.assert_array_equal(a, b, err_msg=mode)


def test_mistral_tp2_greedy_with_lora_matches_jax(world2):
    for m in world2["multi"]:
        for a, b in zip(m["mistral"], world2["jax"]["mistral"]):
            np.testing.assert_array_equal(a, b)


def test_attach_related_world2_equals_world1(world2):
    """The bank split over two ranks: the same neighbours in the same order;
    of two equal rows the lower index comes first."""
    one = world2["one"]["related"]
    for m in world2["multi"]:
        np.testing.assert_array_equal(m["related"], one)
    bank = world2["bank"]
    np.testing.assert_array_equal(one[0, :2], bank[[3, 30]])


def test_allgather_by_index_world2_unequal_counts(world2):
    """Also the axes of a 2 x 1 and a 1 x 2 mesh: no tensor axis over one
    rank, each rank its own index along ``data``."""
    assert [m["axes"] for m in world2["multi"]] == [(None, 2, 2, 2, 0), (None, 2, 2, 2, 1)]
    for m in world2["multi"]:
        np.testing.assert_array_equal(m["allgather"][0][:, 0], [0.0, 10.0, 20.0, 30.0, 40.0])


def _recall_lines(out_dir):
    """The recall lines of every driver log under ``out_dir``, in order."""
    lines = []
    for path in sorted(glob.glob(os.path.join(out_dir, "**", "output.log"), recursive=True)):
        lines += [line.split(" | ", 2)[-1] for line in open(path)
                  if " t2a: " in line or " a2t: " in line]
    return lines


def test_pretrain_and_finetune_world2_match_world1(world2):
    """The drivers at world 2 write (rank 0) the checkpoints of world 1, and
    log its recalls: a capped validation covers the same rows."""
    got, want = _recall_lines(world2["out"]["world2"]), _recall_lines(world2["out"]["world1"])
    assert want and got == want
    for got_dir, want_dir in zip(world2["multi"][0]["drivers"], world2["one"]["drivers"]):
        names = sorted(os.listdir(want_dir))
        assert names and sorted(os.listdir(got_dir)) == names
        for name in names:
            got = torch.load(os.path.join(got_dir, name), map_location="cpu", weights_only=True)
            want = torch.load(os.path.join(want_dir, name), map_location="cpu",
                              weights_only=True)
            assert got["step"] == want["step"] > 0
            g, w = _flat(got["params"]), _flat(want["params"])
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5, err_msg=f"{name} {k}")
            gs, ws = _flat(got["batch_stats"]), _flat(want["batch_stats"])
            for k in ws:
                np.testing.assert_allclose(gs[k], ws[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_train_prompt_data_parallel_world2_matches_world1(world2):
    from zs_aac_tpu_torch.utils.checkpoints import load_params

    got_dir, want_dir = world2["multi"][0]["train_prompt"], world2["one"]["train_prompt"]
    assert world2["multi"][1]["train_prompt"] == got_dir      # rank 0 named the run dir
    g = _flat(_listed(load_params(os.path.join(got_dir, "last.pth"))))
    w = _flat(_listed(load_params(os.path.join(want_dir, "last.pth"))))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5, err_msg=k)
    assert json.load(open(os.path.join(got_dir, "params.json")))["data_parallel"]


def _listed(tree):
    if isinstance(tree, (list, tuple)):
        return {str(i): _listed(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _listed(v) for k, v in tree.items()}
    return tree


def test_dryrun_four_runs_hold_to_one_process():
    """``python -m zs_aac_tpu_torch.parallel.dryrun --nproc 4 --device cpu``:
    ASE dp4, captioner dp2 x tp2, Mistral + LoRA dp2 x tp2 and the tp2
    greedy decode, each within its bound of the one-process run, the
    trained parameters moved well past the bounds."""
    from zs_aac_tpu_torch.parallel import dryrun

    out = dryrun.main(["--nproc", "4", "--device", "cpu"])
    assert out["multi"]["dp"] == 2 and out["multi"]["tp"] == 2
    for name, (err, bound) in out["errors"].items():
        assert err <= bound, (name, err, bound)
    for run in ("ase", "caption", "mistral"):
        assert out["single"][run]["moved"] > 100 * out["errors"][f"{run}_params"][1], run
        assert all(np.isfinite(v).all() for v in out["multi"][run]["params"].values())
