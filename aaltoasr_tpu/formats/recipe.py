"""Recipe (corpus manifest) files with deterministic batch sharding.

Each non-empty, non-comment line is a whitespace-separated list of
``key=value`` fields (`aku/Recipe.hh:14-34`).  Reference parity notes
(`aku/Recipe.cc:24-150`):

* The key->value map is carried over between lines WITHOUT clearing, so a
  line that omits a key inherits the previous line's value.  We reproduce
  this quirk for drop-in compatibility.
* ``read(num_batches, batch_index)`` splits lines deterministically:
  ``target = n // num_batches`` with the remainder spread one extra line
  to the first ``n % num_batches`` batches; ``cluster_speakers`` delays
  batch boundaries until the speaker changes.  This is the reference's
  data-parallel sharding contract (same split the SLURM/Condor workers get);
  on a device mesh the same helper feeds per-device shards of a mesh batch axis.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class RecipeInfo:
    """One utterance: paths and metadata (`aku/Recipe.hh:38-55`)."""

    audio_path: str = ""
    alt_audio_path: str = ""
    transcript_path: str = ""
    alignment_path: str = ""
    hmmnet_path: str = ""
    den_hmmnet_path: str = ""
    lna_path: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    start_line: int = 0
    end_line: int = 0
    speaker_id: str = ""
    utterance_id: str = ""


_KEY_TO_ATTR = {
    "audio": ("audio_path", str),
    "alt-audio": ("alt_audio_path", str),
    "transcript": ("transcript_path", str),
    "alignment": ("alignment_path", str),
    "hmmnet": ("hmmnet_path", str),
    "den-hmmnet": ("den_hmmnet_path", str),
    "lna": ("lna_path", str),
    "start-time": ("start_time", float),
    "end-time": ("end_time", float),
    "start-line": ("start_line", int),
    "end-line": ("end_line", int),
    "speaker": ("speaker_id", str),
    "utterance": ("utterance_id", str),
}


@dataclass
class Recipe:
    infos: list = field(default_factory=list)

    @classmethod
    def read(cls, path_or_lines, num_batches: int = 0, batch_index: int = 0,
             cluster_speakers: bool = False) -> "Recipe":
        """Parse a recipe and keep only the lines of the requested batch.

        Mirrors `aku/Recipe.cc:24-150` exactly, including the sticky
        key-value map and the remainder-spreading batch split.
        """
        if isinstance(path_or_lines, (list, tuple)):
            raw_lines = list(path_or_lines)
        else:
            with open(path_or_lines) as f:
                raw_lines = f.readlines()

        if num_batches > 1 and (batch_index < 1 or batch_index > num_batches):
            raise ValueError("Invalid batch index")

        lines = []
        for line in raw_lines:
            line = line.strip("\n\t ")
            if not line or line.startswith("#"):
                continue
            lines.append(line)

        if num_batches <= 1:
            target_lines = len(lines)
            batch_remainder = 0
        else:
            target_lines = len(lines) // num_batches
            batch_remainder = len(lines) % num_batches
        extra_line = 1
        if target_lines < 1:
            target_lines = 1
            extra_line = 0
        if batch_remainder == 0:
            extra_line = 0

        recipe = cls()
        key_value_map: dict[str, str] = {}  # sticky across lines (reference quirk)
        cur_index = 1
        cur_line = 0
        cur_speaker = ""
        for line in lines:
            for fieldstr in line.split():
                kv = fieldstr.split("=")
                if len(kv) != 2:
                    raise ValueError(f"Invalid recipe line: {line}")
                key_value_map[kv[0]] = kv[1]

            if num_batches > 1 and cur_index < num_batches:
                new_speaker = key_value_map.get("speaker", "")
                if cur_line >= target_lines + extra_line and (
                        not cluster_speakers or not cur_speaker
                        or cur_speaker != new_speaker):
                    cur_index += 1
                    if cur_index > batch_index:
                        break
                    cur_line -= target_lines + extra_line
                    if cur_index > batch_remainder:
                        extra_line = 0
                cur_speaker = new_speaker

            if num_batches <= 1 or cur_index == batch_index:
                info = RecipeInfo()
                for key, (attr, conv) in _KEY_TO_ATTR.items():
                    if key in key_value_map:
                        setattr(info, attr, conv(key_value_map[key]))
                recipe.infos.append(info)
            cur_line += 1
        return recipe

    def sort_by_speaker(self) -> None:
        """Stable sort by speaker id (`aku/Recipe.hh:117-119`)."""
        self.infos.sort(key=lambda i: i.speaker_id)

    def shard(self, num_batches: int, batch_index: int) -> "Recipe":
        """Batch ``batch_index`` (1-based) of an already-parsed recipe,
        with the same remainder-spreading split as :meth:`read`
        (`aku/Recipe.hh:97-112`): the first ``n % num_batches`` batches
        get one extra utterance."""
        if num_batches <= 1:
            return self
        if batch_index < 1 or batch_index > num_batches:
            raise ValueError("Invalid batch index")
        n = len(self.infos)
        target = max(n // num_batches, 1)
        rem = n % num_batches if n // num_batches >= 1 else 0
        start = 0
        for b in range(1, batch_index):
            start += target + (1 if b <= rem else 0)
        size = target + (1 if batch_index <= rem else 0)
        out = Recipe()
        out.infos = self.infos[start:start + size]
        return out

    def __len__(self):
        return len(self.infos)

    def __iter__(self):
        return iter(self.infos)

    def __getitem__(self, i):
        return self.infos[i]
