"""FeatureGenerator: plan the .cfg DAG once, compile to one jitted function.

Where the reference pulls frames one at a time through ring buffers
(`aku/FeatureGenerator.cc`, `aku/FeatureModule.hh:47-154`), this
implementation plans the context windows statically and evaluates every
module over its full extended frame range in one shot:

* Backward pass: for each module, the total left/right context its
  consumers demand (the analog of `compute_init_buffers`,
  `aku/FeatureGenerator.hh:95-100`).
* Base module (`audiofile`): frame ``t`` covers samples ``[t*adv,
  t*adv + W]`` with pre-emphasis ``s[i+1] - coef*s[i]``
  (`aku/FeatureModules.cc:371-440`); out-of-range frames are border copies
  of the first/last valid frame (``copy_borders``), realized as a clamp of
  the frame index — which reproduces the reference's recursive border
  semantics for stacked context modules (delta-of-delta etc.).
* Forward pass: each op maps aligned extended source slices to its own
  extended output range.

The compiled function is shape-polymorphic only over distinct padded sample
lengths (one XLA compilation per padded length; callers should bucket).
Speaker-dependent parameters (VTLN warp, MLLR transform, CMVN) enter as a
pytree argument, so adaptation never recompiles.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aaltoasr_tpu.formats.feaconf import FeatureConfig
from aaltoasr_tpu.frontend import modules as M


def patches_count(num_samples: int, window_width: int, adv: float) -> int:
    """Frames extractable from a stream: floor((S - W - 1)/adv) + 1."""
    return int((num_samples - window_width - 1) / adv) + 1


class FeatureGenerator:
    """Compiled feature frontend for one .cfg configuration."""

    def __init__(self, config: FeatureConfig | str):
        if isinstance(config, str):
            config = FeatureConfig.load(config)
        self.config = config

        base = config.base
        self.base_type = base.type
        bcfg = base.config
        if base.type == "audiofile":
            self.sample_rate = bcfg.get_int("sample_rate")
            if self.sample_rate is None:
                raise ValueError("audiofile: sample_rate is obligatory")
            self.frame_rate = bcfg.get_float("frame_rate", 125.0)
            self.window_width = bcfg.get_int(
                "window_width",
                int(2 * self.sample_rate / self.frame_rate))
            self.copy_borders = bcfg.get_int("copy_borders", 1)
            if not self.copy_borders:
                raise NotImplementedError("copy_borders=0 not supported")
            self.pre_emph_coef = bcfg.get_float("pre_emph_coef", 0.97)
            # float division like the C++ member (FeatureModules.cc:340)
            self.window_advance = self.sample_rate / self.frame_rate
            base_dim = self.window_width
        elif base.type == "pre":
            # precomputed feature files (PreModule,
            # FeatureModules.cc:570-760): dim obligatory, declared rates
            base_dim = bcfg.get_int("dim")
            if base_dim is None:
                raise ValueError("PreModule: Must set dimension")
            self.sample_rate = bcfg.get_int("sample_rate", 16000)
            self.frame_rate = bcfg.get_float("frame_rate", 125.0)
            self.window_width = 0
            self.window_advance = self.sample_rate / self.frame_rate
            self.pre_emph_coef = 0.0
            self.legacy_file = bool(bcfg.get_int("legacy_file", 0))
        else:
            raise NotImplementedError(
                f"base module type '{base.type}' not yet supported")

        # Build ops in config order (sources are guaranteed earlier).
        self.ops: dict[str, M.Op] = {}
        dims = {base.name: base_dim}
        for spec in config.modules[1:]:
            src_dims = [dims[s] for s in spec.sources]
            op = M.build_op(spec.type, spec.config, src_dims, self.sample_rate)
            self.ops[spec.name] = op
            dims[spec.name] = op.out_dim
        self.dims = dims

        # Backward context planning.
        need = {spec.name: [0, 0] for spec in config.modules}
        for spec in reversed(config.modules[1:]):
            op = self.ops[spec.name]
            nl, nr = need[spec.name]
            for s in spec.sources:
                need[s][0] = max(need[s][0], nl + op.left)
                need[s][1] = max(need[s][1], nr + op.right)
        self.need = {k: tuple(v) for k, v in need.items()}

        # Initial runtime params pytree.
        self.params = {name: op.init_params() for name, op in self.ops.items()}
        self.params = {k: v for k, v in self.params.items() if v}

    # -- metadata ---------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.dims[self.config.last.name]

    def num_frames(self, num_samples: int) -> int:
        """Valid frame count: last_frame + 1 (FeatureModules.cc:305-308).

        For a 'pre' base, the input unit is frames already."""
        if self.base_type == "pre":
            return int(num_samples)
        n = (num_samples - self.window_width - 1) / self.window_advance
        return int(n) + 1

    def module_dim(self, name: str) -> int:
        return self.dims[name]

    # -- speaker parameters ----------------------------------------------
    def set_parameters(self, module_name: str, module_config) -> None:
        """Apply a runtime parameter block to one module (.spkc path)."""
        op = self.ops[module_name]
        self.params[module_name] = op.set_parameters(module_config)

    def apply_speaker_config(self, module_map: dict) -> None:
        """Apply all ('feature', name) blocks from a SpeakerConfig map."""
        for (namespace, name), cfg in module_map.items():
            if namespace == "feature":
                self.set_parameters(name, cfg)

    # -- compilation ------------------------------------------------------
    def _base_frames(self, samples, n_frames, ext_l, T_pad, ext_r,
                     start: int = 0):
        """Extended framing+pre-emphasis: [-ext_l, T_pad+ext_r) x window.

        out[t, i] = s[ws+i+1] - c*s[ws+i] for frame start ws: a [T, W+1]
        gather from the sample stream.  Border frames are a row-gather
        clamp afterwards.
        """
        W = self.window_width
        adv = self.window_advance
        n = patches_count(samples.shape[0], W, adv)
        if float(adv).is_integer():
            ws = jnp.arange(n, dtype=jnp.int32) * int(adv)
        else:
            # non-integer advance (rare): float frame starts, truncated
            ws = (jnp.arange(n).astype(jnp.float32)
                  * jnp.float32(adv)).astype(jnp.int32)
        idx = ws[:, None] + jnp.arange(W + 1)[None, :]
        win = samples[jnp.minimum(idx, samples.shape[0] - 1)]
        patches = win[:, 1:] - jnp.float32(self.pre_emph_coef) * win[:, :-1]
        t = jnp.arange(start - ext_l, start + T_pad + ext_r)
        t = jnp.clip(t, 0, jnp.maximum(n_frames - 1, 0))  # border copy
        return jnp.take(patches, t, axis=0)

    @functools.lru_cache(maxsize=None)
    def _compiled(self, padded_len: int, start: int = 0,
                  t_out: int | None = None):
        """Jitted [padded_len] samples -> [T_out, dim] features for
        output frames [start, start + T_out) (start may be negative:
        border-copy frames, the feacat --start-frame semantics)."""
        T_pad = self.num_frames(padded_len) if t_out is None else t_out
        if self.num_frames(padded_len) < 1:
            raise ValueError("audio shorter than frame")
        config = self.config
        ops = self.ops
        need = self.need

        def fn(samples, n_frames, params):
            samples = samples.astype(jnp.float32)
            arrays = {}
            bl, br = need[config.base.name]
            if self.base_type == "pre":
                t = jnp.arange(start - bl, start + T_pad + br)
                t = jnp.clip(t, 0, jnp.maximum(n_frames - 1, 0))
                arrays[config.base.name] = jnp.take(samples, t, axis=0)
            else:
                arrays[config.base.name] = self._base_frames(
                    samples, n_frames, bl, T_pad, br, start=start)
            for spec in config.modules[1:]:
                op = ops[spec.name]
                nl, nr = need[spec.name]
                srcs = []
                for s in spec.sources:
                    snl, _snr = need[s]
                    off = snl - nl - op.left
                    length = T_pad + nl + nr + op.left + op.right
                    srcs.append(arrays[s][off:off + length])
                arrays[spec.name] = op.apply(
                    srcs, params.get(spec.name, {}))
            return arrays[config.last.name]

        return jax.jit(fn)

    # -- public entry points ---------------------------------------------
    def features(self, samples: np.ndarray, num_samples: int | None = None):
        """[S] samples -> [T, dim] features for one utterance.

        `samples` are raw int16-valued floats (the reference reads via
        sf_read_short without scaling, `aku/AudioReader.cc:197`).
        """
        samples = jnp.asarray(samples)
        if num_samples is None:
            num_samples = samples.shape[0]
        T = self.num_frames(num_samples)
        fn = self._compiled(int(samples.shape[0]))
        out = fn(samples, jnp.int32(T), self.params)
        return out[:T]

    def features_range(self, samples: np.ndarray, start_frame: int,
                       end_frame: int):
        """Features for frames [start_frame, end_frame) with border
        copies outside the valid range (feacat --start-frame/--end-frame
        semantics incl. negative starts, `aku/feacat.cc:50-120`)."""
        samples = jnp.asarray(samples)
        n = self.num_frames(int(samples.shape[0]))
        fn = self._compiled(int(samples.shape[0]), int(start_frame),
                            int(end_frame - start_frame))
        return fn(samples, jnp.int32(n), self.params)

    def features_batch(self, samples: np.ndarray, num_samples: np.ndarray):
        """[B, S] padded samples + [B] lengths -> [B, T_pad, dim].

        Rows beyond each utterance's frame count hold border copies of its
        last frame; mask with `num_frames(num_samples[i])`.
        """
        samples = jnp.asarray(samples)
        n_frames = jnp.asarray(
            [self.num_frames(int(n)) for n in np.asarray(num_samples)],
            dtype=jnp.int32)
        fn = self._compiled(int(samples.shape[1]))
        return jax.vmap(fn, in_axes=(0, 0, None))(
            samples, n_frames, self.params)

    # -- diagnostics ------------------------------------------------------
    def print_dot_graph(self, out) -> None:
        """DOT dump of the module DAG (parity with feadot;
        `aku/FeatureGenerator.hh:90`)."""
        out.write("digraph features {\n")
        for spec in self.config.modules:
            out.write(f'  {spec.name} [label="{spec.name}\\n{spec.type}\\n'
                      f'dim={self.dims[spec.name]}"]\n')
            for s in spec.sources:
                out.write(f"  {s} -> {spec.name}\n")
        out.write("}\n")


def read_pre_file(path, dim: int, legacy_file: bool = False):
    """Read a precomputed-feature file (PreModule format,
    FeatureModules.cc:594-640): 1-byte (legacy) or int32 dimension
    header, float32 frames."""
    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    if legacy_file:
        fdim, off = data[0], 1
    else:
        fdim = int(np.frombuffer(data, "<i4", 1)[0])
        off = 4
    if fdim != dim:
        raise ValueError("PreModule: The file has invalid dimension")
    arr = np.frombuffer(data, "<f4", offset=off)
    return arr.reshape(-1, dim).copy()
