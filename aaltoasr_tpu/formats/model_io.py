"""Acoustic model text formats: .gk / .mc / .ph / .dur.

Formats per `aku/doc/fileformats.html` and the reference readers/writers:

* .gk  — Gaussian pool: header ``<num> <dim> <type>`` where type is
  ``diagonal_cov``, ``full_cov``, or ``variable`` (per-Gaussian ``diag`` /
  ``full`` tags).  One Gaussian per line: means then (co)variances
  (`aku/Distributions.cc` PDFPool::read_gk, DiagonalGaussian::read/write).
* .mc  — mixtures: header ``<num_pdfs>``, then per pdf
  ``<K> <idx> <w> ...`` with weights normalized on read
  (`aku/Distributions.cc` Mixture::read/write).
* .ph  — NOWAY HMM topology (``PHONE`` header), phoneme HMMs over tied
  states; transition targets are stored file-encoded (0/1 dummies, 1=sink)
  and converted to offsets relative to the source state
  (`aku/HmmSet.cc:183-316` read_legacy_ph, `:374-424` write_legacy_ph).
* .dur — gamma state-duration parameters.  Version 4: ``4\\n<num_states>``
  then ``<state> <a> <b>`` per line (`aku/dur_est.cc:126-138`; reader
  `decoder/src/NowayHmmReader.cc:92`, versions 1-4 supported).

The in-memory representation is structure-of-arrays, ready to feed the device
scoring kernels (means/covariances as [G, D] NumPy arrays).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class HmmPhone:
    """One phoneme HMM: label and its tied-state (pdf) indices in order."""

    label: str
    states: list[int]  # tied-state indices, shared across phones


@dataclass
class HmmModel:
    """The acoustic model: phones -> tied states -> mixtures -> Gaussians.

    Tied states and emission pdfs share indices (reference
    `aku/HmmSet.cc:310-320`).  Transitions live on tied states; each entry is
    ``(target_offset, prob)`` where the offset is relative to the source
    state's position within a phone and ``offset == states_left`` means phone
    exit.
    """

    dim: int
    cov_type: str                      # 'diagonal_cov' | 'full_cov' | 'variable'
    means: np.ndarray                  # [G, D] float64
    covars: np.ndarray                 # [G, D] diagonal covariances (diag gaussians)
    full_covars: dict = field(default_factory=dict)   # gauss idx -> [D, D] (full type)
    gauss_kind: list = field(default_factory=list)    # per-gaussian 'diag'|'full'|'pcgmm'|'scgmm'
    mixtures: list = field(default_factory=list)      # per pdf: (np[int] indices, np[float] weights)
    phones: list = field(default_factory=list)        # list[HmmPhone]
    transitions: dict = field(default_factory=dict)   # tied state -> [(offset, prob)]
    durations: np.ndarray | None = None               # [S, 2] gamma (a, b) or None
    # subspace-constrained Gaussians (aku/Subspaces.{hh,cc};
    # PDFPool::read_gk "variable" rows, Distributions.cc:2844-2868)
    precision_subspaces: dict = field(default_factory=dict)    # ssid -> PrecisionSubspace
    exponential_subspaces: dict = field(default_factory=dict)  # ssid -> ExponentialSubspace
    pcgmm_params: dict = field(default_factory=dict)   # g -> (ssid, tm[D], coeffs[B])
    scgmm_params: dict = field(default_factory=dict)   # g -> (ssid, coeffs[B])

    # -- derived ----------------------------------------------------------
    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def num_states(self) -> int:
        return len(self.mixtures)

    @property
    def num_phones(self) -> int:
        return len(self.phones)

    def phone(self, label: str) -> HmmPhone:
        for p in self.phones:
            if p.label == label:
                return p
        raise KeyError(f"no phone with label {label!r}")

    def precisions(self) -> np.ndarray:
        """[G, D] precisions; zero where covariance <= 0 (Distributions.cc:1256)."""
        with np.errstate(divide="ignore"):
            prec = np.where(self.covars > 0, 1.0 / self.covars, 0.0)
        return prec

    def gauss_constants(self) -> np.ndarray:
        """Per-Gaussian additive constant ``log sqrt(prod(precision))``.

        NOTE: the reference omits the ``-D/2 log(2*pi)`` normalizer
        (`aku/Distributions.cc:1273-1287` set_constant); likelihoods are
        unnormalized and only ratios matter downstream.
        """
        prec = self.precisions()
        prod = np.prod(prec, axis=1)
        out = np.where(prod > 0, 0.5 * np.log(np.maximum(prod, 1e-300)), 0.0)
        return out


# ---------------------------------------------------------------------------
# .gk
# ---------------------------------------------------------------------------

def read_gk(path) -> tuple[np.ndarray, np.ndarray, str, list, dict, dict]:
    """Parse a .gk -> (means, covars, cov_type, gauss_kind, full_covars,
    subspaces) where subspaces packs the PCGMM/SCGMM payload
    (PDFPool::read_gk, Distributions.cc:2812-2911)."""
    from aaltoasr_tpu.ops.subspaces import (
        ExponentialSubspace, PrecisionSubspace)
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    num = int(next(it))
    dim = int(next(it))
    cov_type = next(it)
    means = np.zeros((num, dim), dtype=np.float64)
    covars = np.ones((num, dim), dtype=np.float64)
    gauss_kind: list[str] = []
    full_covars: dict[int, np.ndarray] = {}
    subspaces = {"precision": {}, "exponential": {},
                 "pcgmm": {}, "scgmm": {}}

    def read_diag(i):
        means[i] = [float(next(it)) for _ in range(dim)]
        covars[i] = [float(next(it)) for _ in range(dim)]
        gauss_kind.append("diag")

    def read_full(i):
        means[i] = [float(next(it)) for _ in range(dim)]
        cov = np.array(
            [float(next(it)) for _ in range(dim * dim)], dtype=np.float64
        ).reshape(dim, dim)
        full_covars[i] = cov
        covars[i] = np.diag(cov)
        gauss_kind.append("full")

    def read_pcgmm(i):
        ssid = int(next(it))
        ps = subspaces["precision"][ssid]
        ss_dim = int(next(it))
        tm = np.array([float(next(it)) for _ in range(dim)])
        lam = np.array([float(next(it)) for _ in range(ss_dim)])
        subspaces["pcgmm"][i] = (ssid, tm, lam)
        P = ps.compute_precision(lam)
        cov = np.linalg.inv(P)
        means[i] = cov @ tm
        covars[i] = np.diag(cov)
        full_covars[i] = cov
        gauss_kind.append("pcgmm")

    def read_scgmm(i):
        ssid = int(next(it))
        es = subspaces["exponential"][ssid]
        ss_dim = int(next(it))
        lam = np.array([float(next(it)) for _ in range(ss_dim)])
        subspaces["scgmm"][i] = (ssid, lam)
        psi, P = es.split_theta(es.compute_theta(lam))
        cov = np.linalg.inv(P)
        means[i] = cov @ psi
        covars[i] = np.diag(cov)
        full_covars[i] = cov
        gauss_kind.append("scgmm")

    if cov_type == "variable":
        i = 0
        while i < num:
            kind = next(it)
            if kind == "diag":
                read_diag(i)
            elif kind == "full":
                read_full(i)
            elif kind == "precision_subspace":
                ssid = int(next(it))
                subspaces["precision"][ssid] = PrecisionSubspace.read(it)
                continue                      # no pool slot consumed
            elif kind == "exponential_subspace":
                ssid = int(next(it))
                subspaces["exponential"][ssid] = \
                    ExponentialSubspace.read(it)
                continue
            elif kind == "pcgmm":
                read_pcgmm(i)
            elif kind == "scgmm":
                read_scgmm(i)
            else:
                raise ValueError(f"Unknown model type {kind}")
            i += 1
    elif cov_type == "diagonal_cov":
        for i in range(num):
            read_diag(i)
    elif cov_type == "full_cov":
        for i in range(num):
            read_full(i)
    elif cov_type == "single_cov":
        # one shared variance value per Gaussian
        for i in range(num):
            means[i] = [float(next(it)) for _ in range(dim)]
            covars[i] = float(next(it))
            gauss_kind.append("diag")
        cov_type = "diagonal_cov"
    else:
        raise ValueError(f"Unknown covariance type {cov_type}")
    return means, covars, cov_type, gauss_kind, full_covars, subspaces


def write_gk(path, model: HmmModel) -> None:
    g = model.num_gaussians
    with open(path, "w") as f:
        if model.cov_type == "variable":
            f.write(f"{g} {model.dim} variable\n")
            # subspaces precede the Gaussians that reference them
            # (PDFPool::write_gk, Distributions.cc:2914-2966)
            for ssid, ps in sorted(model.precision_subspaces.items()):
                f.write(f"precision_subspace {ssid} ")
                ps.write(f)
            for ssid, es in sorted(model.exponential_subspaces.items()):
                f.write(f"exponential_subspace {ssid} ")
                es.write(f)
            for i in range(g):
                kind = model.gauss_kind[i] if model.gauss_kind else "diag"
                if kind == "full":
                    cov = model.full_covars[i]
                    vals = " ".join(_g(x) for x in model.means[i]) + " " + \
                        " ".join(_g(x) for x in cov.reshape(-1))
                    f.write(f"full {vals}\n")
                elif kind == "pcgmm":
                    ssid, tm, lam = model.pcgmm_params[i]
                    f.write(f"pcgmm {ssid} {len(lam)} "
                            + " ".join(_g(x) for x in tm) + " "
                            + " ".join(_g(x) for x in lam) + "\n")
                elif kind == "scgmm":
                    ssid, lam = model.scgmm_params[i]
                    f.write(f"scgmm {ssid} {len(lam)} "
                            + " ".join(_g(x) for x in lam) + "\n")
                else:
                    f.write("diag " + _gauss_line(model, i) + "\n")
        elif model.cov_type == "full_cov":
            f.write(f"{g} {model.dim} full_cov\n")
            for i in range(g):
                cov = model.full_covars[i]
                f.write(" ".join(_g(x) for x in model.means[i]) + " " +
                        " ".join(_g(x) for x in cov.reshape(-1)) + "\n")
        else:
            f.write(f"{g} {model.dim} diagonal_cov\n")
            for i in range(g):
                f.write(_gauss_line(model, i) + "\n")


def _g(x: float) -> str:
    """Format like C++ ostream << double (6 significant digits default).

    The reference writes with full stream precision in practice (operator<<
    defaults); we use repr-style shortest round-trip so reload is lossless.
    """
    return np.format_float_positional(
        float(x), unique=True, trim="0"
    ) if np.isfinite(x) else str(x)


def _gauss_line(model: HmmModel, i: int) -> str:
    return " ".join(_g(x) for x in model.means[i]) + " " + \
        " ".join(_g(x) for x in model.covars[i])


# ---------------------------------------------------------------------------
# .mc
# ---------------------------------------------------------------------------

def read_mc(path) -> list:
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    num = int(next(it))
    mixtures = []
    for _ in range(num):
        k = int(next(it))
        idx = np.zeros(k, dtype=np.int32)
        w = np.zeros(k, dtype=np.float64)
        for j in range(k):
            idx[j] = int(next(it))
            w[j] = float(next(it))
        s = w.sum()
        if s > 0:
            w = w / s  # normalize_weights (Distributions.cc:2061-2076)
        mixtures.append((idx, w))
    return mixtures


def write_mc(path, model: HmmModel) -> None:
    with open(path, "w") as f:
        f.write(f"{len(model.mixtures)}\n")
        for idx, w in model.mixtures:
            parts = [str(len(idx))]
            for i, x in zip(idx, w):
                parts.append(str(int(i)))
                parts.append(_g(x))
            f.write(" ".join(parts) + "\n")


# ---------------------------------------------------------------------------
# .ph
# ---------------------------------------------------------------------------

def read_ph(path) -> tuple[list, dict]:
    """Parse a NOWAY .ph file -> (phones, transitions).

    Transition decoding follows `aku/HmmSet.cc:258-287`: file target ``1``
    is the sink (offset = states - source), otherwise offset =
    (target - 2) - source.  The first phone to reference a tied state
    defines its transitions; later references are ignored.
    """
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    magic = next(it)
    if magic != "PHONE":
        raise ValueError(".ph file must start with PHONE")
    num_phones = int(next(it))
    phones: list[HmmPhone] = []
    transitions: dict[int, list] = {}
    for _ in range(num_phones):
        next(it)  # phone index (1-based, ignored)
        states = int(next(it)) - 2  # minus the two dummy states
        label = next(it)
        next(it), next(it)  # -1 -2 dummy state ids
        pdfs = [int(next(it)) for _ in range(states)]
        phones.append(HmmPhone(label=label, states=pdfs))
        for _file_source in range(states + 2):
            source = int(next(it)) - 2
            ntrans = int(next(it))
            pairs = []
            for _ in range(ntrans):
                target = int(next(it))
                prob = float(next(it))
                if prob <= 0:
                    raise ValueError(
                        f"phone {label}: transition with nonpositive prob {prob}")
                if source >= 0:
                    if target == 1:
                        offset = states - source
                    else:
                        offset = (target - 2) - source
                    pairs.append((offset, prob))
            if source >= 0 and pdfs[source] not in transitions:
                transitions[pdfs[source]] = pairs
    return phones, transitions


def write_ph(path, model: HmmModel) -> None:
    """Write NOWAY .ph (`aku/HmmSet.cc:374-424` write_legacy_ph)."""
    with open(path, "w") as f:
        f.write("PHONE\n")
        f.write(f"{len(model.phones)}\n")
        for h, phone in enumerate(model.phones):
            ns = len(phone.states)
            f.write(f"{h + 1} {ns + 2} {phone.label}\n")
            f.write("-1 -2" + "".join(f" {s}" for s in phone.states) + "\n")
            f.write("0 1 2 1\n")
            f.write("1 0\n")
            for s in range(ns):
                trans = model.transitions.get(phone.states[s], [])
                parts = [str(s + 2), str(len(trans))]
                for offset, prob in trans:
                    target = offset + 2 + s
                    if target == ns + 2:
                        target = 1
                    parts.append(str(target))
                    parts.append(_g(prob))
                f.write(" ".join(parts) + "\n")


# ---------------------------------------------------------------------------
# .dur
# ---------------------------------------------------------------------------

def read_dur(path, num_states: int | None = None) -> np.ndarray:
    """Read gamma duration parameters -> [S, 2] (a, b).

    Supports version 3/4 state-indexed tables (`decoder/src/
    NowayHmmReader.cc:110-140`).  Versions 1/2 are phone-ordered and need
    the HMM topology; pass the model through `read_model` for those.
    """
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    version = int(next(it))
    if version not in (3, 4):
        raise ValueError(f"unsupported .dur version {version} without topology")
    n = int(next(it))
    if version == 3:
        n += 1  # used to be the index of the last state
    table = np.zeros((n, 2), dtype=np.float64)
    for i in range(n):
        sid = int(next(it))
        if sid != i:
            raise ValueError("invalid .dur state table")
        table[i, 0] = float(next(it))
        table[i, 1] = float(next(it))
    return table


def write_dur(path, durations: np.ndarray) -> None:
    """Write version-4 .dur (`aku/dur_est.cc:126-138`)."""
    with open(path, "w") as f:
        f.write(f"4\n{durations.shape[0]}\n")
        for i in range(durations.shape[0]):
            f.write(f"{i} {durations[i, 0]:.4f} {durations[i, 1]:.4f}\n")


# ---------------------------------------------------------------------------
# whole-model io (HmmSet::read_all / write_all, aku/HmmSet.cc:351-441)
# ---------------------------------------------------------------------------

def read_model(base: str, read_durations: bool = False) -> HmmModel:
    (means, covars, cov_type, gauss_kind, full_covars,
     subspaces) = read_gk(base + ".gk")
    mixtures = read_mc(base + ".mc")
    phones, transitions = read_ph(base + ".ph")
    model = HmmModel(
        dim=means.shape[1],
        cov_type=cov_type,
        means=means,
        covars=covars,
        full_covars=full_covars,
        gauss_kind=gauss_kind,
        mixtures=mixtures,
        phones=phones,
        transitions=transitions,
        precision_subspaces=subspaces["precision"],
        exponential_subspaces=subspaces["exponential"],
        pcgmm_params=subspaces["pcgmm"],
        scgmm_params=subspaces["scgmm"],
    )
    if read_durations:
        model.durations = read_dur(base + ".dur", num_states=model.num_states)
    return model


def write_model(base: str, model: HmmModel) -> None:
    write_mc(base + ".mc", model)
    write_ph(base + ".ph", model)
    write_gk(base + ".gk", model)
    if model.durations is not None:
        write_dur(base + ".dur", model.durations)
