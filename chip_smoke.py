#!/usr/bin/env python3
"""End-to-end smoke run of recognition and EM training on one GPU.

    python chip_smoke.py [--seed 0]          # one card
    python chip_smoke.py --four-cards        # the sharded paths, 4 cards

Everything is generated from ``--seed``: the bench's 1k-word cross-word
trigram task with gamma durations, each tied state an 8-component
mixture over a 10,000-Gaussian D=39 pool, 32 WAVs of 8 s, and an
8-utterance tone corpus for training.  The phases:

1. recognize: ``cli.recognize`` from WAV, ``--engine dense
   --decode-batch 32`` and ``--engine exact`` (CLI defaults otherwise);
2. parity: the first utterances through the same CLI in a CPU child
   process (LNA codes at most 2 quantization steps apart and >= 96%
   identical, identical words), and the card's own LNAs decoded on the
   CPU (decoder parity);
3. planted words: `DenseBeamSearch` and `BeamSearch` on 128 planted
   utterances of 1000 frames;
4. train: two EM iterations of ``cli.train``, log-likelihoods matched
   against a CPU child run;
5. the tests marked ``gpu``.

A failing phase exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
CPU child processes never open the card (``JAX_PLATFORMS=cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

FULL = dict(num_words=1000, num_gaussians=10000, mixture=8, n_wavs=32,
            seconds=8.0, decode_batch=32, parity_utts=2, planted_batch=128,
            planted_frames=1000, planted_check=4, train_utts=8)
TINY = dict(num_words=30, num_gaussians=96, mixture=4, n_wavs=3,
            seconds=1.0, decode_batch=2, parity_utts=2, planted_batch=2,
            planted_frames=120, planted_check=2, train_utts=2)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


@contextlib.contextmanager
def phase(name: str, times: dict):
    t0 = time.perf_counter()
    print(f"phase {name} ...", flush=True)
    yield
    times[name] = time.perf_counter() - t0
    print(f"phase {name} ok ({times[name]:.1f} s)", flush=True)


# ---------------------------------------------------------------------------
# task generation
# ---------------------------------------------------------------------------

def _write_wav(path, samples) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(samples, -32768, 32767)
                      .astype("<i2").tobytes())


def _synth_audio(rng, seconds: float):
    """150 ms segments of two random tones plus noise."""
    n = int(16000 * seconds)
    seg = 2400
    t = np.arange(seg) / 16000.0
    parts = []
    for _ in range(-(-n // seg)):
        f = rng.uniform(100.0, 4000.0, 2)
        a = rng.uniform(500.0, 6000.0, 2)
        parts.append((a[:, None] * np.sin(2 * np.pi * f[:, None] * t)
                      ).sum(0) + 150.0 * rng.standard_normal(seg))
    return np.concatenate(parts)[:n]


def write_task(out: str, seed: int = 0, size: dict = FULL) -> dict:
    """The full-width recognition task on disk; returns its paths and
    the in-memory (model, tree, fsa, info) for the planted-word phase."""
    from bench_decode import synth_task
    from __graft_entry__ import _MFCC_CFG
    from aaltoasr_tpu.formats.arpa import write_arpa
    from aaltoasr_tpu.formats.feaconf import FeatureConfig
    from aaltoasr_tpu.formats.model_io import write_model
    from aaltoasr_tpu.frontend.generator import FeatureGenerator

    os.makedirs(out, exist_ok=True)
    model, tree, fsa = synth_task(num_words=size["num_words"], order=3,
                                  triphone=True, durations=True, seed=seed)
    info = synth_task.last_info
    rng = np.random.default_rng([seed, 1])
    wavs = []
    for i in range(size["n_wavs"]):
        path = os.path.join(out, f"u{i:02d}.wav")
        _write_wav(path, _synth_audio(rng, size["seconds"]))
        wavs.append(path)
    cfg = os.path.join(out, "feats.cfg")
    with open(cfg, "w") as f:
        f.write(_MFCC_CFG)
    # Gaussian pool drawn around the corpus' own feature statistics, so
    # state scores spread like a trained model's (rounded, so the pool
    # does not follow the platform's last bits)
    from aaltoasr_tpu.frontend.audio import read_audio
    fg = FeatureGenerator(FeatureConfig.parse(_MFCC_CFG))
    feats = np.concatenate([np.asarray(fg.features(
        read_audio(w, 16000)[0]), np.float64) for w in wavs[:2]])
    mu = np.round(feats.mean(0), 2)
    sd = np.round(feats.std(0) + 0.1, 2)
    G, D, K = size["num_gaussians"], feats.shape[1], size["mixture"]
    model.means = mu + sd * rng.normal(0.0, 1.0, (G, D))
    model.covars = sd ** 2 * rng.uniform(0.3, 1.5, (G, D))
    model.mixtures = [
        (np.sort(rng.choice(G, K, replace=False)).astype(np.int32),
         rng.dirichlet(np.ones(K))) for _ in range(model.num_states)]
    model.dim = D
    am = os.path.join(out, "am")
    write_model(am, model)
    lex = os.path.join(out, "lex.txt")
    with open(lex, "w") as f:
        f.write("\n".join(info["lexicon"]) + "\n")
    lm = os.path.join(out, "lm.arpa")
    write_arpa(info["lm"], lm)
    recipe = os.path.join(out, "all.recipe")
    write_recipe(recipe, wavs)
    return dict(dir=out, am=am, dur=am + ".dur", cfg=cfg, lex=lex, lm=lm,
                recipe=recipe, wavs=wavs, model=model, tree=tree, fsa=fsa,
                info=info)


def write_recipe(path: str, wavs: list) -> str:
    with open(path, "w") as f:
        for w in wavs:
            name = os.path.splitext(os.path.basename(w))[0]
            f.write(f"audio={w} lna={name}.lna\n")
    return path


def write_train_corpus(out: str, model, seed: int, n_utts: int) -> str:
    """Tone corpus in the style of the end-to-end WER test: each phone
    label a 150 ms tone whose frequency follows its centre phone."""
    import zlib
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng([seed, 2])
    labels = [p.label for p in model.phones if not p.label.startswith("_")]

    def centre(lbl):
        return lbl.split("-")[-1].split("+")[0]

    def tone(lbl, n):
        c = centre(lbl)
        f = 150.0 + (zlib.crc32(c.encode()) % 3000)
        t = np.arange(n) / 16000.0
        return 4000.0 * np.sin(2 * np.pi * f * t) + 150.0 * rng.standard_normal(n)

    lines = []
    for u in range(n_utts):
        phones = (["_"] + [labels[int(i)] for i in rng.integers(
            len(labels), size=int(rng.integers(4, 9)))] + ["_"])
        sig = np.concatenate([
            (300.0 * rng.standard_normal(2400)) if p == "_" else tone(p, 2400)
            for p in phones])
        wav = os.path.join(out, f"t{u}.wav")
        _write_wav(wav, sig)
        phn = os.path.join(out, f"t{u}.phn")
        with open(phn, "w") as f:
            f.write("\n".join(phones) + "\n")
        lines.append(f"audio={wav} transcript={phn} lna=t{u}.lna")
    recipe = os.path.join(out, "train.recipe")
    with open(recipe, "w") as f:
        f.write("\n".join(lines) + "\n")
    return recipe


# ---------------------------------------------------------------------------
# CLI runs
# ---------------------------------------------------------------------------

def run_cli(name: str, argv: list) -> str:
    """``aaltoasr_tpu.cli.<name>.main(argv)`` in-process; its stdout."""
    import importlib
    mod = importlib.import_module(f"aaltoasr_tpu.cli.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    check(rc in (0, None), f"{name} returned {rc}")
    return out.getvalue()


def recognize_argv(task: dict, recipe: str, workdir: str, engine: str,
                   decode_batch: int) -> list:
    argv = ["-b", task["am"], "--dur", task["dur"], "-c", task["cfg"],
            "-l", task["lex"], "-n", task["lm"], "-r", recipe,
            "-w", workdir, "--engine", engine, "-i", "-1"]
    if engine == "dense":
        argv += ["--decode-batch", str(decode_batch)]
    return argv


def train_argv(task: dict, recipe: str, workdir: str) -> list:
    return ["-b", task["am"], "-c", task["cfg"], "-r", recipe,
            "-w", workdir, "--id", "m", "--num-iters", "2", "-i", "0"]


def parse_hyps(stdout: str) -> dict:
    """``words (key)`` lines -> {key: [words]}."""
    hyps = {}
    for line in stdout.splitlines():
        if line.endswith(")") and "(" in line:
            text, key = line[:-1].rsplit("(", 1)
            hyps[key] = text.split()
    return hyps


def train_lls(workdir: str) -> list:
    with open(os.path.join(workdir, "m.summary")) as f:
        return [float(line.split()[3]) for line in f]


def lna_codes(path: str) -> np.ndarray:
    """2-byte LNA payload as integer codes [T, S]."""
    with open(path, "rb") as f:
        data = f.read()
    S = int.from_bytes(data[:4], "big")
    check(data[4] == 2, f"{path}: not a 2-byte LNA")
    return np.frombuffer(data[5:], ">u2").astype(np.int32).reshape(-1, S)


def compare_lna(a: str, b: str) -> dict:
    ca, cb = lna_codes(a), lna_codes(b)
    check(ca.shape == cb.shape, f"LNA shapes {ca.shape} vs {cb.shape}")
    d = np.abs(ca - cb)
    return {"max_code_delta": int(d.max()),
            "identical_share": float((d == 0).mean())}


def compare_words(a: dict, b: dict, keys: list) -> list:
    return [k for k in keys if a.get(k) != b.get(k)]


# ---------------------------------------------------------------------------
# CPU child processes
# ---------------------------------------------------------------------------

def start_cpu_child(jobs: list, log: str):
    """Runs [(cli, argv, stdout_path), ...] in a CPU-only child."""
    spec = log + ".json"
    with open(spec, "w") as f:
        json.dump(jobs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-child", spec],
        env=env, stdout=open(log, "w"), stderr=subprocess.STDOUT)


def wait_child(proc, log: str, timeout: float = 900.0) -> None:
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    if rc != 0:
        with open(log) as f:
            tail = f.read()[-4000:]
        raise PhaseError(f"CPU child failed ({rc}):\n{tail}")


def cpu_child(spec: str) -> int:
    import jax
    check(jax.devices()[0].platform == "cpu", "CPU child sees a card")
    with open(spec) as f:
        jobs = json.load(f)
    for name, argv, out in jobs:
        t0 = time.perf_counter()
        text = run_cli(name, argv)
        with open(out, "w") as f:
            f.write(text)
        print(f"cpu child: {name} {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


# ---------------------------------------------------------------------------
# phases on the card
# ---------------------------------------------------------------------------

def frontend_time(task: dict) -> dict:
    """Warm per-utterance time of the compiled MFCC+delta program."""
    import jax
    from aaltoasr_tpu.formats.feaconf import FeatureConfig
    from aaltoasr_tpu.frontend.audio import read_audio
    from aaltoasr_tpu.frontend.generator import FeatureGenerator
    fg = FeatureGenerator(FeatureConfig.load(task["cfg"]))
    batch = [jax.device_put(read_audio(w, 16000)[0]) for w in task["wavs"]]
    jax.block_until_ready(fg.features(batch[0]))
    t0 = time.perf_counter()
    outs = [fg.features(s) for s in batch]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    frames = sum(int(o.shape[0]) for o in outs)
    return {"frontend_s": dt, "frontend_frames_per_s": frames / dt}


def planted_words(task: dict, size: dict) -> dict:
    """Planted-word agreement of both engines at the bench settings."""
    import jax
    from bench_decode import synth_obs
    from aaltoasr_tpu.decoder.search import BeamSearch, SearchConfig
    from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch
    model, tree, fsa = task["model"], task["tree"], task["fsa"]
    B, T = size["planted_batch"], size["planted_frames"]
    obs_fn, true_words = synth_obs(model, task["info"], B, T)
    obs = jax.jit(obs_fn)(jax.random.PRNGKey(1))
    n = np.full(B, T, np.int32)
    engines = {
        "dense": DenseBeamSearch(tree, fsa, model, SearchConfig(
            lm_scale=30.0, duration_scale=3.0, num_records=32,
            records_half=True)),
        "exact": BeamSearch(tree, fsa, model, SearchConfig(
            lm_scale=30.0, duration_scale=3.0, num_tokens=512,
            num_records=32, overflow_tokens=128, we_prewalk=256,
            reentry_records=8, reentry_prewalk=8)),
    }
    out = {}
    for name, search in engines.items():
        t0 = time.perf_counter()
        res = search.decode_batch(obs, n, lattice=False)
        agree = tot = 0
        for b in range(size["planted_check"]):
            ref = [f"w{i}" for i in true_words[b]]
            agree += sum(h == r for h, r in zip(res[b].words, ref))
            tot += len(ref)
        out[name] = {"agree": agree, "total": tot,
                     "seconds": time.perf_counter() - t0}
    return out


def gpu_tests() -> dict:
    """The tests marked ``gpu``, in this process."""
    import pytest

    class Count:
        def __init__(self):
            self.n = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.n[report.outcome] = self.n.get(report.outcome, 0) + 1

    c = Count()
    rc = pytest.main(["-m", "gpu", "-q", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")], plugins=[c])
    c.n["rc"] = int(rc)
    return c.n


def run_all(size: dict, seed: int, work: str,
            run_gpu_tests: bool = True) -> dict:
    """Every one-card phase; raises PhaseError on the first failure."""
    times: dict = {}
    result: dict = {}
    children = []
    try:
        with phase("task", times):
            task = write_task(os.path.join(work, "task"), seed, size)
            tr_recipe = write_train_corpus(
                os.path.join(work, "train_corpus"), task["model"], seed,
                size["train_utts"])
        # the CPU half of the training parity runs beside the card work
        tr_cpu = os.path.join(work, "train_cpu")
        tr_log = os.path.join(work, "train_cpu.log")
        children.append(start_cpu_child(
            [("train", train_argv(task, tr_recipe, tr_cpu),
              tr_log + ".out")], tr_log))

        rec = os.path.join(work, "rec")
        hyps = {}
        for engine in ("dense", "exact"):
            with phase(f"recognize_{engine}", times):
                hyps[engine] = parse_hyps(run_cli("recognize", recognize_argv(
                    task, task["recipe"], rec, engine, size["decode_batch"])))
                check(len(hyps[engine]) == size["n_wavs"],
                      f"{engine}: {len(hyps[engine])} hypotheses")
        result["frontend"] = frontend_time(task)

        # parity: the first utterances from WAV on the CPU, and the
        # card's own LNAs decoded on the CPU
        k = size["parity_utts"]
        sub = write_recipe(os.path.join(work, "parity.recipe"),
                           task["wavs"][:k])
        keys = [f"u{i:02d}.lna" for i in range(k)]
        wav_dir = os.path.join(work, "cpu_wav")
        lna_dir = os.path.join(work, "cpu_lna")
        os.makedirs(os.path.join(lna_dir, "lna"))
        for key in keys:
            shutil.copy(os.path.join(rec, "lna", key),
                        os.path.join(lna_dir, "lna", key))
        p_log = os.path.join(work, "parity_cpu.log")
        jobs = [("recognize", recognize_argv(task, sub, d, e,
                                             size["decode_batch"]),
                 f"{p_log}.{tag}.{e}")
                for tag, d in (("wav", wav_dir), ("lna", lna_dir))
                for e in ("dense", "exact")]
        children.append(start_cpu_child(jobs, p_log))

        with phase("planted", times):
            planted = planted_words(task, size)
            result["planted"] = planted
            print(f"planted: {json.dumps(planted)}", flush=True)
            if size is FULL:
                for name, p in planted.items():
                    check(p["agree"] >= p["total"] - 1,
                          f"planted {name}: {p['agree']}/{p['total']}")

        with phase("train", times):
            tr_gpu = os.path.join(work, "train_gpu")
            run_cli("train", train_argv(task, tr_recipe, tr_gpu))
            ll_gpu = train_lls(tr_gpu)
            check(len(ll_gpu) == 2 and all(np.isfinite(ll_gpu)),
                  f"train LLs {ll_gpu}")

        if run_gpu_tests:
            with phase("gpu_tests", times):
                n = gpu_tests()
                result["gpu_tests"] = n
                check(n["rc"] == 0 and n["failed"] == 0
                      and n["skipped"] == 0 and n["passed"] > 0,
                      f"gpu tests: {n}")

        with phase("cpu_parity", times):
            wait_child(children[0], tr_log)
            ll_cpu = train_lls(tr_cpu)
            rel = [abs(a - b) / abs(b) for a, b in zip(ll_gpu, ll_cpu)]
            result["train"] = {"ll_card": ll_gpu, "ll_cpu": ll_cpu,
                               "rel": rel}
            print(f"train: {json.dumps(result['train'])}", flush=True)
            check(len(ll_cpu) == 2 and max(rel) <= 1e-4,
                  f"train LL card {ll_gpu} vs cpu {ll_cpu}")

            wait_child(children[1], p_log)
            lna = {key: compare_lna(os.path.join(rec, "lna", key),
                                    os.path.join(wav_dir, "lna", key))
                   for key in keys}
            result["lna"] = lna
            print(f"lna parity: {json.dumps(lna)}", flush=True)
            # fp32 bounds this: the card's and the CPU's DFT sums round
            # differently, so cepstra differ by ~1e-4 and log-probs by
            # about one 1/1820 step (~97% of the codes identical, at
            # most 2 steps apart); a TF32 product or a lost payload
            # would move codes by tens of steps
            for key, c in lna.items():
                check(c["max_code_delta"] <= 2
                      and c["identical_share"] >= 0.96,
                      f"LNA parity {key}: {c}")
            diffs = {}
            for tag in ("wav", "lna"):
                for e in ("dense", "exact"):
                    with open(f"{p_log}.{tag}.{e}") as f:
                        cpu = parse_hyps(f.read())
                    diffs[f"{tag}_{e}"] = compare_words(hyps[e], cpu, keys)
            result["word_diffs"] = diffs
            print(f"word parity (keys that differ): {json.dumps(diffs)}",
                  flush=True)
            check(not any(diffs.values()), f"words differ: {diffs}")
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
    result["times"] = times
    return result


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def four_cards(seed: int, n_devices: int = 4, B: int = 32, T: int = 1000,
               G: int = 10000, planted_batch: int = 128,
               planted_frames: int = 1000, num_words: int = 1000) -> dict:
    """Sharded EM step on (n,1) and (n/2,2) meshes and data-sharded
    dense decoding, each against the same work on one card."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from bench_decode import synth_obs, synth_task
    from __graft_entry__ import _random_model
    from aaltoasr_tpu.decoder.search import SearchConfig
    from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch
    from aaltoasr_tpu.models.hmm import (
        TransitionTable, build_chain, pad_chain)
    from aaltoasr_tpu.ops.gmm import GmmScorer
    from aaltoasr_tpu.parallel.mesh import make_mesh, sharded_train_step

    devs = jax.devices()[:n_devices]
    check(len(devs) == n_devices, f"need {n_devices} devices")
    out: dict = {}

    # dense decode sharded over the data axis, first, so that the cards'
    # peak memory reflects only its placement
    dmodel, tree, fsa = synth_task(num_words=num_words, order=3,
                                   triphone=True, durations=True, seed=seed)
    search = DenseBeamSearch(tree, fsa, dmodel, SearchConfig(
        lm_scale=30.0, duration_scale=3.0, num_records=32,
        records_half=True))
    obs_fn, _ = synth_obs(dmodel, synth_task.last_info, planted_batch,
                          planted_frames)
    sh = NamedSharding(Mesh(np.array(devs), ("data",)),
                       PartitionSpec("data"))
    obs_sh = jax.jit(obs_fn, out_shardings=sh)(jax.random.PRNGKey(1))
    check(obs_sh.sharding.device_set == set(devs), "obs not sharded")
    n = np.full(planted_batch, planted_frames, np.int32)
    words_sh = [r.words for r in search.decode_batch(
        obs_sh, jax.device_put(n, sh), lattice=False)]
    # every card did its share (the CPU keeps no memory statistics)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devs]
    out["peak_bytes_sharded_decode"] = peaks
    if None not in peaks:
        check(min(peaks) >= 0.5 * max(peaks),
              f"device peaks uneven (work landed on one card?): {peaks}")
    obs = np.asarray(obs_sh)

    model = _random_model(G=G, S=G // 4, D=39, K=8, seed=seed)
    table = TransitionTable.from_model(model)
    scorer = GmmScorer.from_model(model, pad_gaussians_to=128)
    rng = np.random.default_rng([seed, 3])
    phones = [p.label for p in model.phones]
    chains = [build_chain(model, table, [
        phones[int(i)] for i in rng.integers(len(phones), size=T // 8)])
        for _ in range(B)]
    P = _pow2(max(c.num_positions for c in chains))
    padded = [pad_chain(c, P, fan=4) for c in chains]
    graphs = {k: np.stack([np.asarray(g[k]) for g in padded])
              for k in padded[0]}
    feats = rng.normal(0, 2, (B, T, 39)).astype(np.float32)
    n_frames = np.full((B,), T, np.int32)
    Gp = scorer.score_matrix.shape[1]
    means = np.zeros((Gp, 39), np.float32)
    covars = np.ones((Gp, 39), np.float32)
    means[:G], covars[:G] = model.means, model.covars
    params = {"means": means, "covars": covars,
              "comp_idx": np.asarray(scorer.comp_idx),
              "comp_logw": np.asarray(scorer.comp_logw)}

    def em(mesh):
        step = sharded_train_step(mesh, table.num_slots)
        new, ll = step(params, feats, graphs, n_frames)
        jax.block_until_ready((new, ll))
        return new, float(ll)

    runs = {}
    for shape in ((n_devices, 1), (n_devices // 2, 2)):
        mesh = make_mesh(n_data=shape[0], n_model=shape[1], devices=devs)
        new, ll = em(mesh)
        check(new["means"].sharding.device_set == set(devs),
              f"mesh {shape}: means on {new['means'].sharding.device_set}")
        runs[shape] = ({k: np.asarray(v) for k, v in new.items()}, ll)

    # the same work on one card
    one = make_mesh(n_data=1, n_model=1, devices=devs[:1])
    ref_params, ref_ll = em(one)
    ref_params = {k: np.asarray(v) for k, v in ref_params.items()}
    for shape, (new, ll) in runs.items():
        r = {"ll_rel": abs(ll - ref_ll) / abs(ref_ll),
             "means_rel": _rel(new["means"], ref_params["means"]),
             "covars_rel": _rel(new["covars"], ref_params["covars"])}
        out[f"em_{shape[0]}x{shape[1]}"] = r
        check(r["ll_rel"] <= 1e-6 and r["means_rel"] <= 1e-5
              and r["covars_rel"] <= 1e-5, f"EM mesh {shape}: {r}")
    words_one = [r.words for r in search.decode_batch(
        jax.device_put(obs, devs[0]), n, lattice=False)]
    diff = [b for b in range(planted_batch) if words_one[b] != words_sh[b]]
    out["decode_word_diffs"] = diff
    check(not diff, f"sharded decode differs at {diff}")
    return out


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chip_smoke")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded EM step and sharded dense "
                        "decoding on 4 cards, against one card")
    p.add_argument("--cpu-child", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.cpu_child:
        return cpu_child(args.cpu_child)

    os.environ["JAX_PLATFORMS"] = "cuda"
    t_start = time.perf_counter()
    import jax
    from aaltoasr_tpu.utils.compile_cache import configure_compile_cache
    from aaltoasr_tpu.utils.device import nvidia_smi, require_gpu
    dev = require_gpu("chip_smoke")
    cache = configure_compile_cache()
    count = len(jax.devices())
    print(f"jax {jax.__version__}", flush=True)
    print(f"device: {dev.device_kind} x {count}", flush=True)
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    print(f"compile cache: {cache}", flush=True)

    if args.four_cards:
        res = four_cards(args.seed)
        print(f"four cards: {json.dumps(res)}", flush=True)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            res = run_all(FULL, args.seed, work)
        print(f"stage seconds: {json.dumps(res['times'])}", flush=True)
        print(f"frontend: {json.dumps(res['frontend'])}", flush=True)
    print(f"wall seconds: {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
