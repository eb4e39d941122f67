"""Exact-engine pruning-knob surface (`Toolbox.hh:182-226`).

The reference exposes a family of beams beyond the global one:
word-end beam (`Toolbox.hh:205`, `TokenPassSearch.cc:1076-1081`) and
the compile-time pruning extensions (eq-depth, eq-word-count, fan-in,
fan-out, tp-state; `TokenPassSearch.cc:1083-1127`).  Our batched step
computes the bucket maxima over the same-frame candidate set (strictly
tighter than the reference's previous-frame maxima — see
SearchConfig).  Contract tested here:

- all knobs off (0) == reference defaults (1e10): no behavior change;
- very loose beams must not change the 1-best;
- tight beams still produce a valid decode (pruning, not corruption);
- monophone trees (fan_flags is None) ignore the fan beams.
"""

import subprocess

import numpy as np
import pytest

from aaltoasr_tpu.decoder.search import BeamSearch, SearchConfig
from aaltoasr_tpu.formats.lna import read_lna

from tests.test_golden_crossword import (
    make_triphone_task, synth_crossword_lna)
from tests.test_golden_decode import ref_driver  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("knobs")
    model, words, label_id = make_triphone_task(tmp)
    from aaltoasr_tpu.decoder.toolbox import Toolbox
    t = Toolbox(str(tmp / "m.ph"))
    t.set_lm_scale(8.0)
    t.set_silence_is_word(False)
    t.lex_read(str(tmp / "our_lex.dict"))
    t.set_sentence_boundary("<s>", "</s>")
    t.ngram_read(str(tmp / "lm.arpa"))
    return tmp, model, words, label_id, t


def _decode(t, lp, **kw):
    cfg = SearchConfig(lm_scale=8.0, num_tokens=256, num_records=32,
                       **kw)
    s = BeamSearch(t.tree, t.lm, t.model, cfg)
    return s, s.decode(lp)


LOOSE = dict(word_end_beam=1e8, eq_depth_beam=1e8,
             eq_word_count_beam=1e8, fan_in_beam=1e8,
             fan_out_beam=1e8, tp_state_beam=1e8)


class TestPruningKnobs:
    def test_fan_flags_built_on_crossword_tree(self, task):
        tmp, model, words, label_id, t = task
        ff = t.tree.fan_flags
        assert ff is not None
        assert (ff & 1).any() and (ff & 2).any()

    def test_loose_beams_do_not_change_1best(self, task):
        tmp, model, words, label_id, t = task
        for i, seq in enumerate([["ab", "ba"], ["ca", "bc", "a"],
                                 ["a", "ab"]]):
            lna = synth_crossword_lna(tmp, model, words, label_id,
                                      seq, seed=30 + i,
                                      name=f"k{i}.lna")
            lp, _ = read_lna(lna)
            _, off = _decode(t, lp)
            _, loose = _decode(t, lp, **LOOSE)
            assert loose.words == off.words, seq
            assert loose.log_prob == pytest.approx(off.log_prob,
                                                   rel=1e-5)

    def test_word_end_beam_loose_vs_tight(self, task):
        tmp, model, words, label_id, t = task
        lna = synth_crossword_lna(tmp, model, words, label_id,
                                  ["ab", "ba"], seed=40,
                                  name="web.lna")
        lp, _ = read_lna(lna)
        _, off = _decode(t, lp)
        _, loose = _decode(t, lp, word_end_beam=1e8)
        assert loose.words == off.words
        # a tight word-end beam keeps only near-best word ends; the
        # decode must still complete and produce words
        _, tight = _decode(t, lp, word_end_beam=5.0)
        assert len(tight.words) >= 1
        # non-vacuity: the beam visibly prunes word-end records while
        # the moderate setting keeps the 1-best
        def live(web):
            cfg = SearchConfig(lm_scale=8.0, num_tokens=256,
                               num_records=32, word_end_beam=web)
            s = BeamSearch(t.tree, t.lm, t.model, cfg)
            r = s.decode(lp, lattice=True)
            return int(np.sum(np.asarray(r.rec_words) >= 0)), r.words
        n_off, _ = live(0.0)
        n_25, w_25 = live(25.0)
        assert n_25 < n_off // 2
        assert w_25 == off.words

    def test_tight_beams_still_decode(self, task):
        tmp, model, words, label_id, t = task
        lna = synth_crossword_lna(tmp, model, words, label_id,
                                  ["bc", "a"], seed=41, name="tb.lna")
        lp, _ = read_lna(lna)
        # note: at lm_scale 8 a fan-in beam of ~20 collapses the
        # search on this task (re-entering word ends pay the scaled LM
        # cost and compete against in-word fan-in paths — the same
        # cliff the reference has); 30+ decodes correctly
        _, r = _decode(t, lp, eq_depth_beam=30.0,
                       eq_word_count_beam=30.0, fan_in_beam=30.0,
                       fan_out_beam=30.0, tp_state_beam=30.0)
        assert len(r.words) >= 1

    def test_reentry_records_full_is_identity(self, task):
        tmp, model, words, label_id, t = task
        lna = synth_crossword_lna(tmp, model, words, label_id,
                                  ["ca", "bc"], seed=42, name="rr.lna")
        lp, _ = read_lna(lna)
        _, full = _decode(t, lp)
        # Er == E is exactly the default path
        _, same = _decode(t, lp, reentry_records=32)
        assert same.words == full.words
        assert same.log_prob == pytest.approx(full.log_prob, rel=1e-5)
        # a generous slice (records are compacted best-first) keeps
        # the 1-best on these short tasks
        _, sl = _decode(t, lp, reentry_records=16)
        assert sl.words == full.words

    def test_reentry_prewalk_identity_and_slice(self, task):
        tmp, model, words, label_id, t = task
        lna = synth_crossword_lna(tmp, model, words, label_id,
                                  ["ab", "ba", "a"], seed=43,
                                  name="rp.lna")
        lp, _ = read_lna(lna)
        s, full = _decode(t, lp)
        R = int(t.tree.root_pair_tgt.shape[1])
        # RK >= R keeps everything (full path)
        _, same = _decode(t, lp, reentry_prewalk=R)
        assert same.words == full.words
        assert same.log_prob == pytest.approx(full.log_prob, rel=1e-5)
        # a generous per-record entry budget keeps the 1-best (the
        # score may dip slightly: a pruned entry can contribute to
        # the winning path's mass on noisy frames)
        _, sl = _decode(t, lp, reentry_prewalk=max(4, R // 2))
        assert sl.words == full.words
        # composes with the record slice
        _, both = _decode(t, lp, reentry_prewalk=max(4, R // 2),
                          reentry_records=16)
        assert both.words == full.words

    def test_reentry_prewalk_with_lookahead(self, task):
        tmp, model, words, label_id, t = task
        lna = synth_crossword_lna(tmp, model, words, label_id,
                                  ["ca", "ab"], seed=44,
                                  name="rpl.lna")
        lp, _ = read_lna(lna)
        _, full = _decode(t, lp, lm_lookahead=1)
        R = int(t.tree.root_pair_tgt.shape[1])
        _, sl = _decode(t, lp, lm_lookahead=1,
                        reentry_prewalk=max(4, R // 2))
        assert sl.words == full.words

    def test_monophone_tree_ignores_fan_beams(self):
        from tests.test_decoder import make_decode_task, synth_obs
        model, tree, fsa = make_decode_task()
        assert tree.fan_flags is None
        cfg = SearchConfig(num_tokens=256, num_records=16,
                           lm_scale=1.0, fan_in_beam=1.0,
                           fan_out_beam=1.0, tp_state_beam=1.0)
        s = BeamSearch(tree, fsa, model, cfg)
        obs = synth_obs(tree, model, ["a", "b", "a"], seed=1)
        r = s.decode(obs)
        cfg0 = SearchConfig(num_tokens=256, num_records=16,
                            lm_scale=1.0)
        s0 = BeamSearch(tree, fsa, model, cfg0)
        r0 = s0.decode(obs)
        assert r.words == r0.words

    def test_word_end_beam_golden_parity(self, task, ref_driver):
        """1-best parity vs the REFERENCE decoder with the word-end
        beam matched on both sides (`--we-beam` plumbs straight to
        `Toolbox::set_word_end_beam`, Toolbox.hh:205).  Ours prunes
        against the same-frame best word end (strictly tighter than
        the reference's previous-frame maxima), so agreement at a
        beam that actually prunes is the semantic check."""
        tmp, model, words, label_id, t = task
        for i, (seq, web) in enumerate([(["ab", "ba"], 40.0),
                                        (["ca", "bc", "a"], 40.0),
                                        (["a", "ab"], 25.0)]):
            lna = synth_crossword_lna(tmp, model, words, label_id,
                                      seq, seed=50 + i,
                                      name=f"web{i}.lna")
            out = subprocess.run(
                [ref_driver, "--ph", str(tmp / "m.ph"),
                 "--lex", str(tmp / "ref_lex.dict"),
                 "--arpa", str(tmp / "lm.arpa"), "--lna", lna,
                 "--beam", "500", "--we-beam", str(web),
                 "--token-limit", "200000", "--lm-scale", "8",
                 "--dur-scale", "0", "--trans-scale", "1",
                 "--no-oss"],
                check=True, capture_output=True, text=True,
                timeout=180)
            ref = [w for w in out.stdout.split()
                   if w not in ("<s>", "</s>", "*")]
            lp, _ = read_lna(lna)
            _, ours = _decode(t, lp, word_end_beam=web)
            assert ours.words == ref, (seq, web)

    def test_toolbox_knob_setters(self, task):
        tmp, model, words, label_id, t = task
        for name, attr in [
                ("set_word_end_beam", "word_end_beam"),
                ("set_eq_depth_beam", "eq_depth_beam"),
                ("set_eq_word_count_beam", "eq_word_count_beam"),
                ("set_fan_in_beam", "fan_in_beam"),
                ("set_fan_out_beam", "fan_out_beam"),
                ("set_tp_state_beam", "tp_state_beam")]:
            getattr(t, name)(123.0)
            assert getattr(t.config, attr) == 123.0
            getattr(t, name)(0.0)


class TestObsComposeParity:
    """obs_compose=1 (the large-tree composition mode, incl. the
    dedup two-step gathers: pdf_tri / pdf_over_u / re-entry
    row tables) must decode bit-identically to the default
    shared-index mode — the restructurings select the same elements,
    so words AND scores must match."""

    def test_compose_matches_default(self, task):
        tmp, model, words, label_id, t = task
        for i, seq in enumerate([["ab", "ba"], ["ca", "bc", "a"]]):
            lna = synth_crossword_lna(tmp, model, words, label_id,
                                      seq, seed=60 + i,
                                      name=f"oc{i}.lna")
            lp, _ = read_lna(lna)
            knobs = dict(overflow_tokens=32, we_prewalk=64,
                         reentry_records=8, reentry_prewalk=8)
            s0, off = _decode(t, lp, obs_compose=0, **knobs)
            s1, comp = _decode(t, lp, obs_compose=1, **knobs)
            assert s1._obs_compose and s1._tri and s1._over_shared
            assert comp.words == off.words, seq
            assert comp.log_prob == pytest.approx(off.log_prob,
                                                  rel=1e-6)
