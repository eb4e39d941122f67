"""aaltoasr_tpu — an accelerator-native LVCSR framework with AaltoASR's capabilities.

A from-scratch JAX/XLA/Pallas re-design of the classical HMM/GMM speech
recognition toolkit AaltoASR (Aku acoustic trainer + token-passing decoder +
pyrectool batch driver).  The compute path is batched, jitted, and sharded
over `jax.sharding.Mesh`; the file formats (.cfg/.gk/.mc/.ph/.dur/.lna/
.phn/recipe/.spkc/ARPA/SLF) are kept compatible with the reference so models
and artifacts interoperate bidirectionally.

Subpackages
-----------
formats   host-side parsers/writers for every reference interchange format
frontend  the feature-extraction DAG compiled to one fused jitted function
ops       core array ops and Pallas kernels (GMM scoring, log-semiring scans)
models    acoustic model state (HMM topology, tied states, Gaussian pools)
train     Viterbi alignment, Baum-Welch E-step, ML/EBW M-step, adaptation
decoder   lexical-prefix-tree beam search, n-gram LMs, lattices
parallel  mesh/sharding helpers and collective reductions
cli       command-line tools mirroring the reference's aku/decoder binaries
"""

__version__ = "0.2.0"

# convenience top-level API (the common serve/train surfaces)
from aaltoasr_tpu.decoder.toolbox import Toolbox                 # noqa: F401,E402
from aaltoasr_tpu.formats.model_io import read_model, write_model  # noqa: F401,E402
from aaltoasr_tpu.frontend.generator import FeatureGenerator     # noqa: F401,E402


def __getattr__(name):
    # heavier classes resolved lazily to keep bare import light
    if name == "BeamSearch":
        from aaltoasr_tpu.decoder.search import BeamSearch
        return BeamSearch
    if name == "DenseBeamSearch":
        from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch
        return DenseBeamSearch
    if name == "PhoneProbs":
        from aaltoasr_tpu.models.phone_probs import PhoneProbs
        return PhoneProbs
    raise AttributeError(name)
