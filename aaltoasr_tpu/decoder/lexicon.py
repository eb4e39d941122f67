"""Lexicon reading and the flattened HMM-state prefix tree.

Reference: `decoder/src/TPNowayLexReader.cc` (format: ``word(prob) ph1
ph2 ...`` per line, '_' = silence) and `decoder/src/TPLexPrefixTree.
{hh,cc}` (pointer-based tree of HMM-state nodes with cross-word
fan-in/fan-out networks).  This build is accelerator-first: the tree is
compiled into dense SoA arrays the batched beam search consumes directly —

* per node: emission pdf, duration-state id, dense out-arc table
  ``[N, A]`` (in-word arcs: self-loops, forward/skip transitions, phone-
  trie branch arcs), and up to H word-end slots (word id, pronunciation
  ln-prob, exit ln-prob) for homophone ends;
* root arcs ``[R]``: entries into every first phone state (the epsilon
  closure of word-end -> root -> first states, so the device search needs
  exactly one in-word expansion + one word-end expansion per frame).

Triphone lexicons build cross-word fan-in/fan-out variants
(`TPLexPrefixTree.hh:172-240`): boundary phones get one copy per
context class, word ends carry (last-phone class, assumed-next-class
set) pair ids, and re-entry gathers the matching ``root_pair_tgt``
row — so the device search pays exactly one extra [E] gather per frame
for full cross-word context modeling.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from aaltoasr_tpu.formats.model_io import HmmModel
from aaltoasr_tpu.ops.logsemiring import LOG_ZERO

LN10 = 2.302585092994046


@dataclass
class LexiconEntry:
    word: str
    phones: list
    prob: float = 1.0


def read_lexicon(path_or_text) -> list:
    """Parse a NOWAY lexicon: ``word(prob) phone ...`` per line."""
    if "\n" in str(path_or_text):
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    entries = []
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        word = parts[0]
        prob = 1.0
        if "(" in word:
            left = word.rfind("(")
            right = word.rfind(")")
            if left < 0 or right < 0:
                raise ValueError(f"invalid probability in {word!r}")
            prob = float(word[left + 1:right])
            word = word[:left]
        entries.append(LexiconEntry(word=word, phones=parts[1:], prob=prob))
    return entries


@dataclass
class PrefixTree:
    """Flattened lexical prefix tree (monophone or cross-word triphone)."""

    num_nodes: int
    vocab: list                    # word id -> string
    word_index: dict
    pdf: np.ndarray                # [N] emission pdf per node
    dur_state: np.ndarray          # [N] tied state for duration model
    arc_tgt: np.ndarray            # [N, A] in-word arcs (self-pad)
    arc_logp: np.ndarray           # [N, A] (LOG_ZERO pad)
    we_word: np.ndarray            # [N, H] word ids ending here (-1 pad)
    we_exit_logp: np.ndarray       # [N, H] exit transition ln-prob (AM side)
    we_pron_logp: np.ndarray       # [N, H] pronunciation ln-prob (LM side,
                                   #        cm_log_prob in the reference)
    we_skip_lm: np.ndarray         # [N, H] bool: no LM score (silence)
    root_tgt: np.ndarray           # [R] entry nodes (union over contexts)
    root_logp: np.ndarray          # [R]
    silence_word: int = -1
    # cross-word triphone re-entry (TPLexPrefixTree fan-in/fan-out,
    # decoder/src/TPLexPrefixTree.hh:172-240).  A word end carries a
    # pair id = (last monophone class of the word, set of next first
    # phones its fan-out variant assumed); re-entry gathers that row.
    # Monophone trees degenerate to one row == the union root arcs, so
    # the search kernel is context-free of the tree flavor.
    we_pair: np.ndarray | None = None        # [N, H] pair ids
    root_pair_tgt: np.ndarray | None = None  # [P, R]
    root_pair_logp: np.ndarray | None = None # [P, R]
    init_pair: int = 0                       # utterance-initial row
    # pair factorization: pair = left_class * num_rcsets + rcset, and
    # membership of an entry node in a pair row is the PRODUCT
    # (left_class in variant.left) * (variant.first_class in rcset) —
    # the dense searcher exploits this to merge re-entries with two
    # small matmuls instead of materializing [P, R] one-hots
    num_classes: int = 1
    num_rcsets: int = 1
    # per-node fan flags (bit0 = fan-in network, bit1 = fan-out;
    # single-phone words carry both — TPLexPrefixTree NODE_FAN_IN /
    # NODE_FAN_OUT, TPLexPrefixTree.hh:55-60).  None on monophone
    # trees (no fan network; the fan beams are inert).
    fan_flags: np.ndarray | None = None

    def __post_init__(self):
        if self.root_pair_tgt is None:
            R = len(self.root_tgt)
            self.root_pair_tgt = self.root_tgt.reshape(1, R)
            self.root_pair_logp = self.root_logp.reshape(1, R)
        if self.we_pair is None:
            self.we_pair = np.zeros(self.we_word.shape, dtype=np.int32)


def expand_context_phones(phones: list, phone_map: dict,
                          boundary: str = "_") -> list:
    """Map a word's phone sequence to context-dependent model labels.

    For tied-triphone models (labels like ``l-c+r`` from decision-tree
    tying) each within-word phone resolves with fallbacks: full triphone
    -> left biphone -> right biphone -> monophone.  Word boundaries use
    the ``boundary`` context (cross-word fan-in/fan-out networks,
    `TPLexPrefixTree.hh:172-240`, are a planned extension).  Monophone
    lexicons pass through unchanged.
    """
    out = []
    n = len(phones)
    for i, p in enumerate(phones):
        left = phones[i - 1] if i > 0 else boundary
        right = phones[i + 1] if i + 1 < n else boundary
        for cand in (f"{left}-{p}+{right}", f"{left}-{p}", f"{p}+{right}",
                     p):
            if cand in phone_map:
                out.append(cand)
                break
        else:
            out.append(p)  # unknown; caller reports it
    return out


def _resolve_context(phone_map: dict, left: str, p: str,
                     right: str) -> str | None:
    """Tied-triphone label with fallbacks: l-c+r -> l-c -> c+r -> c."""
    for cand in (f"{left}-{p}+{right}", f"{left}-{p}", f"{p}+{right}", p):
        if cand in phone_map:
            return cand
    return None


def build_prefix_tree(model: HmmModel, entries: list,
                      silence_is_word: bool = True,
                      use_context_phones: bool | None = None,
                      cross_word: bool | None = None,
                      boundary: str = "_",
                      optional_short_silence: bool = False,
                      word_boundary: str = "") -> PrefixTree:
    """Compile lexicon entries against the acoustic model's phones.

    use_context_phones: expand lexicon monophone strings to the model's
    tied context-dependent labels (auto-detected from the model's phone
    inventory by default).
    silence_is_word: when False, every lexicon word starting with '_'
    is a non-LM silence (TPNowayLexReader.cc:153).
    optional_short_silence: reference semantics for a 1-emitting-state
    '_' entry (TPLexPrefixTree.cc:132-141): it is NOT a word path but
    an optional short-silence loop crossed between word end and
    re-entry (TPLexPrefixTree m_optional_short_silence).
    cross_word: build fan-in/fan-out variants for the word-boundary
    phones so triphone contexts hold ACROSS words (TPLexPrefixTree
    fan-in/fan-out, `decoder/src/TPLexPrefixTree.hh:172-240`); defaults
    to use_context_phones.  Cross-word trees support
    optional_short_silence too: per word-end-pair looping '_' nodes
    between fan-out and re-entry (TPLexPrefixTree.cc:822-832).
    """
    phone_map = {p.label: p for p in model.phones}
    if use_context_phones is None:
        use_context_phones = any(
            ("-" in lbl or "+" in lbl) for lbl in phone_map)
    if cross_word is None:
        cross_word = use_context_phones
    if use_context_phones and cross_word:
        return _build_crossword_tree(model, entries, phone_map,
                                     boundary, silence_is_word,
                                     optional_short_silence,
                                     word_boundary)
    if use_context_phones:
        entries = [
            LexiconEntry(word=e.word,
                         phones=expand_context_phones(e.phones, phone_map),
                         prob=e.prob)
            for e in entries]

    vocab: list[str] = []
    word_index: dict[str, int] = {}

    def wid(w: str) -> int:
        if w not in word_index:
            word_index[w] = len(vocab)
            vocab.append(w)
        return word_index[w]

    # trie over phone sequences; trie node = phone instance
    # phone instance -> its emitting node range
    pdf: list[int] = []
    dur_state: list[int] = []
    arcs: list[list] = []          # per node: [(tgt, logp)]
    we: list[list] = []            # per node: [(word, logp, skip_lm)]

    def new_node(pdf_id: int) -> int:
        pdf.append(pdf_id)
        dur_state.append(pdf_id)
        arcs.append([])
        we.append([])
        return len(pdf) - 1

    def log(p: float) -> float:
        return math.log(p) if p > 0 else LOG_ZERO

    # trie: key = tuple of phone labels -> (first_node, entry logp slots)
    # each phone instance: nodes for its states; in-phone transitions per
    # the model topology; exits collected for chaining.
    class PhoneInstance:
        def __init__(self, label):
            phone = phone_map[label]
            self.label = label
            self.nodes = [new_node(s) for s in phone.states]
            self.exits = []  # (node, logp) pairs leaving the phone
            k = len(phone.states)
            for i, s in enumerate(phone.states):
                for off, prob in model.transitions.get(s, []):
                    lp = log(prob)
                    if i + off < k:
                        arcs[self.nodes[i]].append(
                            (self.nodes[i + off], lp))
                    elif i + off == k:
                        self.exits.append((self.nodes[i], lp))
            self.children: dict[str, PhoneInstance] = {}

    root_children: dict[str, PhoneInstance] = {}

    short_sil_phone = None
    for e in entries:
        if not e.phones:
            continue
        if any(ph not in phone_map for ph in e.phones):
            import sys
            missing = [ph for ph in e.phones if ph not in phone_map][0]
            print(f"build_prefix_tree: unknown hmm {missing} in word "
                  f"'{e.word}'", file=sys.stderr)
            continue
        if (optional_short_silence and e.phones == ["_"]
                and len(phone_map[e.phones[0]].states) == 1
                and e.word in ("_", word_boundary)):
            # a word whose pronunciation is the 1-state '_' model = the
            # optional short silence, not a word path
            # (TPLexPrefixTree.cc:132-141 keys on the pron; in morph
            # lexicons the entry is named after the word boundary,
            # e.g. '<w> _')
            short_sil_phone = phone_map[e.phones[0]]
            continue
        level = root_children
        inst = None
        for ph in e.phones:
            if ph not in level:
                child = PhoneInstance(ph)
                if inst is not None:
                    for (n, lp) in inst.exits:
                        arcs[n].append((child.nodes[0], lp))
                level[ph] = child
            inst = level[ph]
            level = inst.children
        # word end on the final states of the last phone.  '_' (silence)
        # is never a vocabulary word, nor is any '_'-initial word when
        # silence_is_word is off (TPNowayLexReader.cc:153-160): no LM
        # score, no insertion penalty, no output.
        is_silence = (e.word == "_"
                      or (not silence_is_word
                          and e.word.startswith("_")))
        w = -1 if is_silence else wid(e.word)
        for (n, lp) in inst.exits:
            # pron prob: the reference scales safe_log(prob) (NATURAL,
            # TPLexPrefixTree.cc:921) by lm_scale; our engines multiply
            # the lm side by lm_scale/ln10, so pre-multiply by ln10
            we[n].append((w, lp, LN10 * log(e.prob), is_silence))

    root_tgt = [c.nodes[0] for c in root_children.values()]
    root_logp = [0.0] * len(root_tgt)
    silence_word = -1

    if short_sil_phone is not None:
        # optional short silence: word-end re-entry may pass through a
        # looping 1-state silence before the root fan-out
        s0 = short_sil_phone.states[0]
        n_ss = new_node(s0)
        self_lp = exit_lp = LOG_ZERO
        for off, prob in model.transitions.get(s0, []):
            if off == 0:
                self_lp = log(prob)
            elif off == 1:
                exit_lp = log(prob)
        arcs[n_ss].append((n_ss, self_lp))
        if word_boundary:
            # morph mode: leaving the short silence COMMITS the word
            # boundary (LM-scored, printed); re-entry then runs
            # through the ordinary word-end machinery
            we[n_ss].append((wid(word_boundary), exit_lp, 0.0, False))
        else:
            for tgt in root_tgt:
                arcs[n_ss].append((tgt, exit_lp))
        root_tgt.append(n_ss)
        root_logp.append(0.0)

    N = len(pdf)
    A = max((len(a) for a in arcs), default=1)
    H = max((len(h) for h in we), default=1)
    arc_tgt = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, A))
    arc_logp = np.full((N, A), LOG_ZERO, dtype=np.float32)
    we_word = np.full((N, H), -1, dtype=np.int32)
    we_exit = np.full((N, H), LOG_ZERO, dtype=np.float32)
    we_pron = np.zeros((N, H), dtype=np.float32)
    we_skip = np.zeros((N, H), dtype=bool)
    for n in range(N):
        for a, (tgt, lp) in enumerate(arcs[n]):
            arc_tgt[n, a] = tgt
            arc_logp[n, a] = lp
        for h, (w, lp, pron, skip) in enumerate(we[n]):
            we_word[n, h] = w
            we_exit[n, h] = lp
            we_pron[n, h] = pron
            we_skip[n, h] = skip

    return PrefixTree(
        num_nodes=N, vocab=vocab, word_index=word_index,
        pdf=np.asarray(pdf, dtype=np.int32),
        dur_state=np.asarray(dur_state, dtype=np.int32),
        arc_tgt=arc_tgt, arc_logp=arc_logp,
        we_word=we_word, we_exit_logp=we_exit, we_pron_logp=we_pron,
        we_skip_lm=we_skip,
        root_tgt=np.asarray(root_tgt, dtype=np.int32),
        root_logp=np.asarray(root_logp, dtype=np.float32),
        silence_word=silence_word)


def _build_crossword_tree(model: HmmModel, entries: list,
                          phone_map: dict, boundary: str,
                          silence_is_word: bool = True,
                          optional_short_silence: bool = False,
                          word_boundary: str = ""
                          ) -> PrefixTree:
    """Cross-word triphone tree: boundary phones expand into context
    variants (fan-in per preceding class, fan-out per following class);
    interiors stay a shared trie keyed by the resolved label chain.

    Word ends carry pair ids (last monophone class, fan-out class set);
    ``root_pair_tgt[pair]`` lists the fan-in entries that continue them.

    Tied-model minimization: boundary variants are keyed by their TIED
    STATE SEQUENCE, not their label — decision-tree tying maps many
    context labels to the same physical states, and such variants are
    acoustically identical, so they merge (context sets union).  The
    reference builds one node chain per label (`TPLexPrefixTree.cc`
    fan-in/fan-out); a dense searcher pays for every node every frame,
    so the minimized network is the right form for it.  Decode scores
    are unchanged: merged variants had identical emission pdfs,
    transitions, and continuations.
    """
    import sys

    words = [e for e in entries if e.phones]

    def _is_sil(e):
        # TPNowayLexReader.cc:153-160 silence semantics, as in the
        # monophone builder: '_' always, '_'-initial words when
        # silence_is_word is off
        return (e.word == "_"
                or (not silence_is_word and e.word.startswith("_")))

    def _sil_chain(e):
        # routed through the context-transparent silence chain below:
        # silence-named entries and silence-pronounced words ('</s>'
        # mapped to '__' in morph lexicons)
        return (_is_sil(e)
                or (len(e.phones) == 1 and e.phones[0] in ("_", "__")))

    # context classes come from REAL words only: silences carry the
    # boundary context on both sides (the reference wires its silence
    # copies with '_' contexts, TPLexPrefixTree.cc:700-720,1131), so a
    # silence phone is never a triphone context class itself
    classes = sorted({e.phones[0] for e in words if not _sil_chain(e)}
                     | {e.phones[-1] for e in words if not _sil_chain(e)}
                     | {boundary})
    cid = {c: i for i, c in enumerate(classes)}
    NC = len(classes)

    vocab: list = []
    word_index: dict = {}

    def wid(w):
        if w not in word_index:
            word_index[w] = len(vocab)
            vocab.append(w)
        return word_index[w]

    pdf: list = []
    dur_state: list = []
    arcs: list = []
    we: list = []

    def new_node(pdf_id):
        pdf.append(pdf_id)
        dur_state.append(pdf_id)
        arcs.append([])
        we.append([])
        return len(pdf) - 1

    def log(p):
        return math.log(p) if p > 0 else LOG_ZERO

    class Inst:
        def __init__(self, label):
            phone = phone_map[label]
            self.nodes = [new_node(s) for s in phone.states]
            self.exits = []
            k = len(phone.states)
            for i, s in enumerate(phone.states):
                for off, prob in model.transitions.get(s, []):
                    lp = log(prob)
                    if i + off < k:
                        arcs[self.nodes[i]].append(
                            (self.nodes[i + off], lp))
                    elif i + off == k:
                        self.exits.append((self.nodes[i], lp))

    class Variant:
        def __init__(self, label):
            self.inst = Inst(label)
            self.exit_inst = self.inst   # last Inst (chains: silences)
            self.left: set = set()       # allowed preceding classes
            self.rset: set = set()       # assumed following classes
            self.first_class = -1        # monophone class of phone 1
            self.ends: list = []         # (word, pron, skip, last_cls)

    short_sil_phone = None   # set by a 1-state '_' entry under oss
    interior: dict = {}      # tuple(monophones incl right ctx) -> Inst
    fanin: dict = {}         # (p1, p2) -> {label: Variant}
    fanout: dict = {}        # tuple(word phones) -> {label: Variant}
    single: dict = {}        # p1 -> {label: Variant}
    silences: dict = {}      # label chain -> Variant (boundary ctx)
    edges: set = set()       # (src Inst id, tgt node) wired once

    def wire(src: Inst, dst: Inst):
        key = (id(src), dst.nodes[0])
        if key in edges:
            return
        edges.add(key)
        for (n, lp) in src.exits:
            arcs[n].append((dst.nodes[0], lp))

    for e in words:
        p = e.phones
        k = len(p)
        is_sil = _is_sil(e)
        w = -1 if is_sil else wid(e.word)
        if (optional_short_silence and p == ["_"]
                and len(phone_map[p[0]].states) == 1
                and e.word in ("_", word_boundary)):
            # 1-state '_' = the optional short-silence model woven
            # between word end and re-entry (TPLexPrefixTree.cc:
            # 132-141, link_fan_out_node_to_fan_in :822-832), not a
            # word path
            short_sil_phone = phone_map[p[0]]
            continue
        if _sil_chain(e):
            # silences are context-transparent: one un-fanned chain,
            # enterable after ANY word end (left = all classes) and
            # followed by anything (rset = all); its committed context
            # pair is (boundary, all) so the next word re-enters with
            # a '_' left context — the reference's silence wiring
            # (TPLexPrefixTree.cc:700-720, fan-out silence :1131).
            # Silence-NAMED entries end as skip (no LM walk, no
            # output); a silence-PRONOUNCED word (morph lexicons map
            # '</s>' to the long silence '__', TPLexPrefixTree.cc:143
            # keys the silence path on the hmm label) commits its word
            # id like the reference's m_silence_node word.
            lbls = []
            for i in range(k):
                left = p[i - 1] if i else boundary
                right = p[i + 1] if i + 1 < k else boundary
                lbl = _resolve_context(phone_map, left, p[i], right)
                if lbl is None:
                    lbls = None
                    break
                lbls.append(lbl)
            if lbls is None:
                print(f"build_prefix_tree: unknown hmm in silence "
                      f"'{e.word}'", file=sys.stderr)
                continue
            key = tuple(lbls)
            v = silences.get(key)
            if v is None:
                v = silences[key] = Variant(lbls[0])
                v.chain = [v.inst]
                cur = v.inst
                for lbl in lbls[1:]:
                    nxt = Inst(lbl)
                    wire(cur, nxt)
                    cur = nxt
                    v.chain.append(nxt)
                v.exit_inst = cur
                v.first_class = cid[boundary]
                v.left = set(range(NC))
                v.rset = set(range(NC))
            v.ends.append((w, LN10 * log(e.prob), w < 0,
                           cid[boundary]))
            continue
        if k == 1:
            vd = single.setdefault(p[0], {})
            variants = {}
            for c in classes:
                for r in classes:
                    lbl = _resolve_context(phone_map, c, p[0], r)
                    if lbl is None:
                        continue          # this context pair unmodeled
                    skey = tuple(phone_map[lbl].states)
                    v = vd.get(skey)
                    if v is None:
                        v = vd[skey] = Variant(lbl)
                        v.first_class = cid[p[0]]
                    v.left.add(cid[c])
                    v.rset.add(cid[r])
                    variants[skey] = v
            if not variants:
                print(f"build_prefix_tree: unknown hmm {p[0]} in "
                      f"word '{e.word}'", file=sys.stderr)
                continue
            for v in variants.values():
                v.ends.append((w, LN10 * log(e.prob), is_sil, cid[p[0]]))
            continue

        # resolve everything before touching shared state
        first_lbls = {c: _resolve_context(phone_map, c, p[0], p[1])
                      for c in classes}
        first_lbls = {c: l for c, l in first_lbls.items()
                      if l is not None}
        inner_lbls = [_resolve_context(phone_map, p[i - 1], p[i],
                                       p[i + 1])
                      for i in range(1, k - 1)]
        last_lbls = {r: _resolve_context(phone_map, p[k - 2], p[k - 1],
                                         r)
                     for r in classes}
        last_lbls = {r: l for r, l in last_lbls.items()
                     if l is not None}
        if (not first_lbls or not last_lbls
                or any(l is None for l in inner_lbls)):
            bad = (p[0] if not first_lbls else
                   p[k - 1] if not last_lbls else
                   p[1 + inner_lbls.index(None)])
            print(f"build_prefix_tree: unknown hmm {bad} in word "
                  f"'{e.word}'", file=sys.stderr)
            continue

        # fan-in variants of the first phone (merged by tied states)
        fi = fanin.setdefault((p[0], p[1]), {})
        first_vars = {}
        for c, lbl in first_lbls.items():
            skey = tuple(phone_map[lbl].states)
            v = fi.get(skey)
            if v is None:
                v = fi[skey] = Variant(lbl)
                v.first_class = cid[p[0]]
            v.left.add(cid[c])
            first_vars[skey] = v

        # shared interior chain
        prev_insts = [v.inst for v in first_vars.values()]
        for i in range(1, k - 1):
            key = tuple(p[:i + 2])
            inst = interior.get(key)
            if inst is None:
                inst = interior[key] = Inst(inner_lbls[i - 1])
            for src in prev_insts:
                wire(src, inst)
            prev_insts = [inst]

        # fan-out variants of the last phone (merged by tied states)
        fo = fanout.setdefault(tuple(p), {})
        last_vars = {}
        for r, lbl in last_lbls.items():
            skey = tuple(phone_map[lbl].states)
            v = fo.get(skey)
            if v is None:
                v = fo[skey] = Variant(lbl)
            v.rset.add(cid[r])
            last_vars[skey] = v
        for v in last_vars.values():
            for src in prev_insts:
                wire(src, v.inst)
            v.ends.append((w, LN10 * log(e.prob), is_sil, cid[p[k - 1]]))

    # ---- pair table: (last class, rc set) -> root row
    all_variants = ([v for d in fanin.values() for v in d.values()]
                    + [v for d in single.values() for v in d.values()]
                    + list(silences.values()))
    end_variants = ([v for d in fanout.values() for v in d.values()]
                    + [v for d in single.values() for v in d.values()]
                    + list(silences.values()))
    rcsets: dict = {}

    def rcset_id(fs):
        fs = frozenset(fs)
        if fs not in rcsets:
            rcsets[fs] = len(rcsets)
        return rcsets[fs]

    full_set = rcset_id(frozenset(range(NC)))
    for v in end_variants:
        v.rcid = rcset_id(v.rset)

    # optional short silence between word end and cross-word re-entry
    # (TPLexPrefixTree.cc:822-832): one looping 1-state '_' node per
    # word-end pair (the pair id carries the cross-word context the
    # reference preserves by wiring a silence copy per fan-out link).
    # The silence's own exit re-enters a CONTENT-DUPLICATE rc-set id
    # whose row lacks the silence node, so silence cannot chain into
    # itself through the word-end machinery (the reference's silence
    # arcs lead only to fan-in nodes).  Both row families stay products
    # of (left-class) x (rc-set membership) — the dense engine's
    # factored-merge invariant.
    rcset_list = [None] * len(rcsets)
    for fs, i in rcsets.items():
        rcset_list[i] = fs
    used_pairs: set = set()
    nosil_rc: dict = {}
    if short_sil_phone is not None:
        for v in end_variants:
            for (w2, pron2, skip2, last_cls2) in v.ends:
                # real word ends only: the reference inserts the oss
                # between fan-out and fan-in (TPLexPrefixTree.cc:822),
                # never after a silence chain (whose pair carries the
                # boundary class)
                if not skip2 and last_cls2 != cid[boundary]:
                    used_pairs.add((last_cls2, v.rcid))
        for (_c, rc) in sorted(used_pairs):
            if rc not in nosil_rc:
                nosil_rc[rc] = len(rcset_list)
                rcset_list.append(rcset_list[rc])
    NR = len(rcset_list)
    P = NC * NR

    rows_tgt: list = [[] for _ in range(P)]
    rows_lp: list = [[] for _ in range(P)]
    for pair in range(P):
        c_id, rc_i = divmod(pair, NR)
        rc = rcset_list[rc_i]
        for v in all_variants:
            if c_id in v.left and v.first_class in rc:
                rows_tgt[pair].append(v.inst.nodes[0])
                rows_lp[pair].append(0.0)

    ss_nodes = []
    if short_sil_phone is not None:
        s0 = short_sil_phone.states[0]
        self_lp = exit_lp = LOG_ZERO
        for off, prob in model.transitions.get(s0, []):
            if off == 0:
                self_lp = log(prob)
            elif off == 1:
                exit_lp = log(prob)
        wb_w = wid(word_boundary) if word_boundary else -1
        for (c, rc) in sorted(used_pairs):
            n_ss = new_node(s0)
            arcs[n_ss].append((n_ss, self_lp))
            we[n_ss].append((wb_w, exit_lp, 0.0, wb_w < 0,
                             c * NR + nosil_rc[rc]))
            rows_tgt[c * NR + rc].append(n_ss)
            rows_lp[c * NR + rc].append(0.0)
            ss_nodes.append(n_ss)

    # word ends on the exit states, tagged with the pair id
    for v in end_variants:
        for (w, pron, skip, last_cls) in v.ends:
            pair = last_cls * NR + v.rcid
            for (n, lp) in v.exit_inst.exits:
                we[n].append((w, lp, pron, skip, pair))

    init_pair = cid.get(boundary, 0) * NR + full_set
    union = sorted({v.inst.nodes[0] for v in all_variants})

    # ---- pack to SoA
    N = len(pdf)
    # fan flags: bit0 = fan-in (word-initial context variants), bit1 =
    # fan-out (word-final variants); single-phone words are both
    fan_flags = np.zeros(N, dtype=np.int32)
    for d in fanin.values():
        for v in d.values():
            fan_flags[v.inst.nodes] |= 1
    for d in fanout.values():
        for v in d.values():
            fan_flags[v.inst.nodes] |= 2
    for d in single.values():
        for v in d.values():
            fan_flags[v.inst.nodes] |= 3
    for v in silences.values():
        # silence copies live in the fan network (NODE_FAN_OUT on the
        # reference's fan-out silence, TPLexPrefixTree.cc:1131)
        for inst in v.chain:
            fan_flags[inst.nodes] |= 2
    for n_ss in ss_nodes:
        fan_flags[n_ss] |= 2
    A = max((len(a) for a in arcs), default=1)
    H = max((len(h) for h in we), default=1)
    R = max((len(r) for r in rows_tgt), default=1)
    arc_tgt = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, A))
    arc_logp = np.full((N, A), LOG_ZERO, dtype=np.float32)
    we_word = np.full((N, H), -1, dtype=np.int32)
    we_exit = np.full((N, H), LOG_ZERO, dtype=np.float32)
    we_pron = np.zeros((N, H), dtype=np.float32)
    we_skip = np.zeros((N, H), dtype=bool)
    we_pair = np.zeros((N, H), dtype=np.int32)
    for n in range(N):
        for a, (tgt, lp) in enumerate(arcs[n]):
            arc_tgt[n, a] = tgt
            arc_logp[n, a] = lp
        for h, (w, lp, pron, skip, pair) in enumerate(we[n]):
            we_word[n, h] = w
            we_exit[n, h] = lp
            we_pron[n, h] = pron
            we_skip[n, h] = skip
            we_pair[n, h] = pair
    root_pair_tgt = np.zeros((P, R), dtype=np.int32)
    root_pair_logp = np.full((P, R), LOG_ZERO, dtype=np.float32)
    for pair in range(P):
        for r, (tgt, lp) in enumerate(zip(rows_tgt[pair],
                                          rows_lp[pair])):
            root_pair_tgt[pair, r] = tgt
            root_pair_logp[pair, r] = lp

    return PrefixTree(
        num_nodes=N, vocab=vocab, word_index=word_index,
        pdf=np.asarray(pdf, dtype=np.int32),
        dur_state=np.asarray(dur_state, dtype=np.int32),
        arc_tgt=arc_tgt, arc_logp=arc_logp,
        we_word=we_word, we_exit_logp=we_exit, we_pron_logp=we_pron,
        we_skip_lm=we_skip,
        root_tgt=np.asarray(union, dtype=np.int32),
        root_logp=np.zeros(len(union), dtype=np.float32),
        we_pair=we_pair, root_pair_tgt=root_pair_tgt,
        root_pair_logp=root_pair_logp, init_pair=init_pair,
        num_classes=NC, num_rcsets=NR, fan_flags=fan_flags)


def duration_table(model: HmmModel, max_dur: int = 64,
                   scale: float = 1.0) -> np.ndarray:
    """[S, max_dur] gamma duration log-probs; row zero if no model.

    log p(d) = (a-1) ln d - d/b - a ln b - lgamma(a)
    (`decoder/src/Hmm.cc:16-39`).  Index d-1 holds duration d.
    """
    S = model.num_states
    out = np.zeros((S, max_dur), dtype=np.float32)
    if model.durations is None:
        return out
    for s in range(S):
        a, b = model.durations[s]
        if a > 0 and b > 0:
            d = np.arange(1, max_dur + 1, dtype=np.float64)
            out[s] = ((a - 1) * np.log(d) - d / b
                      - a * np.log(b) - math.lgamma(a)) * scale
    return out


def node_duration_params(tree, model: HmmModel, scale: float) -> dict:
    """Per-node gamma duration parameters so a searcher computes
    bonus = scale*((a-1) ln d - d/b - a ln b - lgamma(a)) elementwise —
    identical values to `duration_table` (same formula, `Hmm.cc:16-39`)
    with NO per-token table gather in the step (the elementwise form is a
    handful of vector passes; the gather's cost on the H100 is not
    measured)."""
    from scipy.special import gammaln
    N = tree.num_nodes
    valid = np.zeros(N, np.float32)
    lncoef = np.zeros(N, np.float32)
    invb = np.zeros(N, np.float32)
    const = np.zeros(N, np.float32)
    if model.durations is not None:
        s = np.asarray(tree.dur_state, dtype=np.int64)
        in_range = s < model.durations.shape[0]
        da = model.durations[np.where(in_range, s, 0), 0]
        db = model.durations[np.where(in_range, s, 0), 1]
        ok = in_range & (da > 0) & (db > 0)
        da_s = np.where(ok, da, 1.0)
        db_s = np.where(ok, db, 1.0)
        valid = ok.astype(np.float32)
        lncoef = np.where(ok, scale * (da_s - 1.0), 0.0).astype(np.float32)
        invb = np.where(ok, scale / db_s, 0.0).astype(np.float32)
        const = np.where(ok, scale * (-da_s * np.log(db_s)
                                      - gammaln(da_s)), 0.0).astype(
                                          np.float32)
    return {"dur_valid": valid, "dur_lncoef": lncoef,
            "dur_invb": invb, "dur_const": const}
