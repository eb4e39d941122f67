"""Golden parity for the remaining aku tools: dur_est, feanorm, segfea,
lda, gcluster — each compared against the reference binary built offline
by tools/build_aku.sh on a shared synthetic corpus.

Anchors:
* dur_est: gamma duration ML fit (`aku/dur_est.cc:56-140`) — byte-equal
  .dur output (the golden-section search is replicated in doubles).
* feanorm: corpus CMVN into a normalization module
  (`aku/feanorm.cc:173-283`) — mean/scale parity (the reference
  accumulates in blocks of 1000, so tolerances are float-level).
* segfea: per-tied-state feature dumps (`aku/segfea.cc:226-358`) —
  byte-equal binary dumps + occurrence counts, both phone-division and
  --stateseg modes including the eof-truncation path.
* lda: whitened discriminant transform (`aku/lda.cc:376-466`) —
  row-sign-normalized matrix parity (eigenvector signs are
  solver-specific).
* gcluster: diagonal-KL k-means with glibc rand() init
  (`aku/gcluster.cc:132-291`) — exact .gcl parity via the replicated
  glibc generator.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from aaltoasr_tpu.formats import model_io
from aaltoasr_tpu.formats.feaconf import FeatureConfig

sys.path.insert(0, os.path.dirname(__file__))

from test_train import three_state_model  # noqa: E402
from test_train_cli import CFG  # noqa: E402
from test_golden_stats import make_corpus  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
BUILD = os.path.join(REPO, "build", "aku")
TOOLS = ["align", "dur_est", "feanorm", "segfea", "lda", "gcluster"]

NORM_CFG = CFG + """\
module
{
  name norm
  type normalization
  sources mllt
}
"""

LDA_CFG = CFG + """\
module
{
  name lda
  type lin_transform
  sources mllt
  dim 2
}
"""


@pytest.fixture(scope="module")
def aku_bins():
    if not all(os.path.exists(os.path.join(BUILD, t)) for t in TOOLS):
        if not os.path.isdir("/root/reference/aku"):
            pytest.skip("reference aku tree unavailable")
        try:
            subprocess.run(
                [os.path.join(REPO, "tools", "build_aku.sh")] + TOOLS,
                check=True, capture_output=True, timeout=900)
        except (subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            pytest.skip(f"aku offline build failed: {e}")
    return BUILD


def lda_model(seed=5, D=4):
    """three_state_model + a '__' phone: lda.cc:86-92 unconditionally
    looks up both '_' and '__'."""
    rng = np.random.default_rng(seed)
    G = 8
    means = rng.normal(0, 3, (G, D))
    covars = rng.uniform(0.5, 2.0, (G, D))
    mixtures = [
        (np.array([0, 1], dtype=np.int32), np.array([0.6, 0.4])),
        (np.array([2, 3], dtype=np.int32), np.array([0.5, 0.5])),
        (np.array([4, 5], dtype=np.int32), np.array([0.7, 0.3])),
        (np.array([6, 7], dtype=np.int32), np.array([0.5, 0.5])),
    ]
    phones = [model_io.HmmPhone("a", [0, 1]), model_io.HmmPhone("_", [2]),
              model_io.HmmPhone("__", [3])]
    transitions = {
        0: [(0, 0.6), (1, 0.4)],
        1: [(0, 0.5), (1, 0.5)],
        2: [(0, 0.7), (1, 0.3)],
        3: [(0, 0.7), (1, 0.3)],
    }
    return model_io.HmmModel(
        dim=D, cov_type="diagonal_cov", means=means, covars=covars,
        mixtures=mixtures, phones=phones, transitions=transitions)


@pytest.fixture(scope="module")
def corpus(aku_bins, tmp_path_factory):
    """Shared corpus with reference state alignments (recipe.ref)."""
    tmp = tmp_path_factory.mktemp("tools_corpus")
    make_corpus(tmp)
    subprocess.run(
        [os.path.join(aku_bins, "align"), "-b", "am", "-c", "feats.cfg",
         "-r", "recipe.ref"],
        cwd=tmp, check=True, capture_output=True, timeout=300)
    (tmp / "norm.cfg").write_text(NORM_CFG)
    return tmp


def run_ours(main, args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        assert main(args) == 0
    finally:
        os.chdir(old)


class TestDurEst:
    def test_gamma_dur_parity(self, aku_bins, corpus):
        subprocess.run(
            [os.path.join(aku_bins, "dur_est"), "-p", "am.ph",
             "-r", "recipe.ref", "-O", "--gamma", "ref.dur",
             "--mincount", "2"],
            cwd=corpus, check=True, capture_output=True, timeout=300)
        from aaltoasr_tpu.cli.dur_est import main
        run_ours(main, ["-b", "am", "-r", "recipe.ref", "-O",
                        "-o", "our.dur", "--min-count", "2"], corpus)
        ref = (corpus / "ref.dur").read_text().split()
        ours = (corpus / "our.dur").read_text().split()
        assert ref == ours


class TestFeanorm:
    def test_cmvn_parity(self, aku_bins, corpus):
        subprocess.run(
            [os.path.join(aku_bins, "feanorm"), "-c", "norm.cfg",
             "-r", "recipe.ref", "-M", "norm", "-w", "ref_norm.cfg"],
            cwd=corpus, check=True, capture_output=True, timeout=300)
        from aaltoasr_tpu.cli.feanorm import main
        run_ours(main, ["-c", "norm.cfg", "-r", "recipe.ref",
                        "-M", "norm", "-o", "our_norm.cfg"], corpus)
        ref = FeatureConfig.load(corpus / "ref_norm.cfg").by_name["norm"]
        ours = FeatureConfig.load(corpus / "our_norm.cfg").by_name["norm"]
        for key, rtol in (("mean", 2e-4), ("scale", 2e-4)):
            r = np.asarray(ref.config.get_float_vec(key))
            o = np.asarray(ours.config.get_float_vec(key))
            np.testing.assert_allclose(o, r, rtol=rtol, atol=1e-5,
                                       err_msg=key)


class TestSegfea:
    BIND = "a 2 0 1\n_ 1 2\n"

    @pytest.mark.parametrize("stateseg", [False, True])
    def test_state_dump_parity(self, aku_bins, corpus, tmp_path,
                               stateseg):
        (corpus / "bind").write_text(self.BIND)
        tag = "ss" if stateseg else "ph"
        if stateseg:
            # state mode reads the label.state alignments (-O -s)
            recipe, extra = "recipe.ref", ["-O", "-s"]
        else:
            # phone mode must see timed phone-level phns: the
            # reference only strips '.state' under -s
            # (segfea.cc:267-274), so merge alignment lines per phone
            from aaltoasr_tpu.formats.phn import read_phn
            lines = []
            for u in range(3):
                segs = []
                for e in read_phn(corpus / f"u{u}.ref.phn"):
                    if segs and segs[-1][2] == e.label \
                            and e.state > 0:
                        segs[-1][1] = e.end
                    else:
                        segs.append([e.start, e.end, e.label])
                (corpus / f"u{u}.seg.phn").write_text(
                    "".join(f"{s} {e} {l}\n" for s, e, l in segs))
                lines.append(f"audio={corpus}/u{u}.wav "
                             f"transcript={corpus}/u{u}.seg.phn")
            (corpus / "recipe.seg").write_text("\n".join(lines) + "\n")
            recipe, extra = "recipe.seg", []
        # TEXT output: the reference's --binary mode is buggy — it
        # fwrites only num_frames floats instead of num_frames*dim
        # (segfea.cc:88-90 passes the frame count as the element count)
        subprocess.run(
            [os.path.join(aku_bins, "segfea"), "-b", "bind",
             "-c", "feats.cfg", "-r", recipe,
             "-o", f"refsf_{tag}", "--occ", f"ref_{tag}.occ"] + extra,
            cwd=corpus, check=True, capture_output=True, timeout=300)
        from aaltoasr_tpu.cli.segfea import main
        out_dir = tmp_path / f"ours_{tag}"
        our_extra = [a for a in extra if a != "-O"]
        run_ours(main, ["-c", "feats.cfg", "-r", recipe,
                        "-B", "bind", "-o", str(out_dir)]
                 + (["-O"] if "-O" in extra else [])
                 + ["--occ", str(tmp_path / f"our_{tag}.occ")]
                 + our_extra, corpus)

        ref_occ = (corpus / f"ref_{tag}.occ").read_text().split()
        our_occ = (tmp_path / f"our_{tag}.occ").read_text().split()
        assert ref_occ == our_occ

        for s in range(3):
            ref_file = corpus / f"refsf_{tag}_{s}"
            our_file = out_dir / f"state_{s}.fea"
            if not ref_file.exists():
                assert not our_file.exists()
                continue
            r = np.asarray(ref_file.read_text().split(), dtype=np.float64)
            o = np.frombuffer(our_file.read_bytes(), dtype="<f4")
            assert r.shape == o.shape, s
            np.testing.assert_allclose(o, r, rtol=0, atol=1e-4,
                                       err_msg=f"state {s}")


class TestLda:
    def test_transform_parity(self, aku_bins, corpus):
        model_io.write_model(str(corpus / "am2"), lda_model())
        (corpus / "lda.cfg").write_text(LDA_CFG)
        # fresh alignments against am2 (same state topology for a/_)
        lines = []
        for u in range(3):
            lines.append(f"audio={corpus}/u{u}.wav "
                         f"transcript={corpus}/u{u}.phn "
                         f"alignment={corpus}/u{u}.lda.phn")
        (corpus / "recipe.lda").write_text("\n".join(lines) + "\n")
        subprocess.run(
            [os.path.join(aku_bins, "align"), "-b", "am2",
             "-c", "feats.cfg", "-r", "recipe.lda"],
            cwd=corpus, check=True, capture_output=True, timeout=300)
        subprocess.run(
            [os.path.join(aku_bins, "lda"), "-p", "am2.ph",
             "-c", "lda.cfg", "-r", "recipe.lda", "-O", "-M", "lda",
             "-d", "2", "--mingamma", "2", "-w", "ref_lda.cfg"],
            cwd=corpus, check=True, capture_output=True, timeout=300)
        from aaltoasr_tpu.cli.lda import main
        run_ours(main, ["-p", "am2", "-c", "lda.cfg", "-r", "recipe.lda",
                        "-O", "-M", "lda", "-d", "2", "--mingamma", "2",
                        "-w", "our_lda.cfg"], corpus)

        def matrix(path):
            spec = FeatureConfig.load(path).by_name["lda"]
            m = np.asarray(spec.config.get_float_vec("matrix"))
            return m.reshape(spec.config.get_int("dim"), -1)

        ref = matrix(corpus / "ref_lda.cfg")
        ours = matrix(corpus / "our_lda.cfg")
        assert ref.shape == ours.shape == (2, 4)
        # eigenvector signs are solver-specific: compare each row
        # against the reference row under the better of the two signs
        for r in range(2):
            d = min(np.abs(ours[r] - ref[r]).max(),
                    np.abs(ours[r] + ref[r]).max())
            assert d < 1e-4, (r, d, ours[r], ref[r])


class TestGcluster:
    def test_gcl_parity(self, aku_bins, tmp_path):
        rng = np.random.default_rng(11)
        G, D = 64, 4
        means = rng.normal(0, 4, (G, D))
        covars = rng.uniform(0.3, 3.0, (G, D))
        mixtures = [(np.arange(G, dtype=np.int32), np.full(G, 1.0 / G))]
        model = model_io.HmmModel(
            dim=D, cov_type="diagonal_cov", means=means, covars=covars,
            mixtures=mixtures, phones=[model_io.HmmPhone("a", [0])],
            transitions={0: [(0, 0.5), (1, 0.5)]})
        model_io.write_model(str(tmp_path / "pool"), model)
        subprocess.run(
            [os.path.join(aku_bins, "gcluster"), "-g", "pool.gk",
             "-o", "ref.gcl", "-C", "8"],
            cwd=tmp_path, check=True, capture_output=True, timeout=300)
        from aaltoasr_tpu.cli.gcluster import main
        run_ours(main, ["-b", "pool", "-o", "our.gcl", "-C", "8"],
                 tmp_path)
        ref = (tmp_path / "ref.gcl").read_text().split()
        ours = (tmp_path / "our.gcl").read_text().split()
        assert ref == ours
