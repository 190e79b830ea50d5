"""Train/val/test split assignment per dataset.

A copy of ``mapanything_tpu/data/splits.py`` (:1-233) with its own copy of
``reference_splits.json``, after the reference's
``mapanything/datasets/utils/data_splits.py``. The benchmark-set lists
(BlendedMVS, ScanNet++V2, TartanAirV2-WB, MegaDepth, Spring) are kept
verbatim in ``reference_splits.json``: benchmark comparability needs the
same scene sets, and the reference's ScanNet++ 80/10/10 draw is not
reproducible from a seed (np.random.choice under unknown global state,
data_splits.py:1625-1639). Rules remain for datasets whose split is the
documented rule (BlendedMVS hex-mod-10, MPSD precomputed npys, path
prefixes) and as the fallback for scenes outside the kept lists.

Use :func:`assign_split` to classify a scene, or :func:`split_scenes` to
partition a scene list into {"train", "val", "test"}.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


@functools.lru_cache(None)
def reference_split_lists() -> Dict[str, Dict[str, object]]:
    """The vendored reference scene lists (reference_splits.json)."""
    path = Path(__file__).with_name("reference_splits.json")
    with open(path) as f:
        return json.load(f)

# Curated validation/test scene lists (reference data_splits.py:1570-1601)
TARTANAIRV2_VAL = ("EndofTheWorld", "HongKong", "WesternDesertTown")
TARTANAIRV2_TEST = (
    "DesertGasStation",
    "OldScandinavia",
    "PolarSciFi",
    "Sewerage",
    "Supermarket",
)
MEGADEPTH_VAL = ("0015_0", "0015_1", "0022_0")  # DUSt3R's val scenes
SPRING_VAL = ("0013", "0023", "0037")


class SplitRule:
    """Assigns one of train/val/test to each scene name."""

    def assign(self, scene_name: str, all_scenes: Sequence[str]) -> str:
        raise NotImplementedError


class NamedValTestRule(SplitRule):
    """Fixed val/test name lists; everything else trains."""

    def __init__(self, val=(), test=()):
        self.val = {str(v) for v in val}
        self.test = {str(t) for t in test}

    def assign(self, scene_name, all_scenes):
        base = scene_name.split("/")[-1]
        if scene_name in self.val or base in self.val:
            return "val"
        if scene_name in self.test or base in self.test:
            return "test"
        return "train"


class HexMod10Rule(SplitRule):
    """BlendedMVS / DUSt3R rule (reference data_splits.py:17-41): the low
    16 hex digits of the scene id mod 10 pick val (==0) vs train (>0)."""

    def assign(self, scene_name, all_scenes):
        try:
            seql = int(scene_name[8:], 16)
        except ValueError:
            return "train"
        return "val" if (seql % 10) == 0 else "train"


class SeededFractionRule(SplitRule):
    """Seeded random test/val fractions of the available scenes
    (reference ScanNet++ 80/10/10 logic, data_splits.py:1625-1639, and
    RandomSplitAggregator in aggregate_metadata.py:259)."""

    def __init__(self, val_frac=0.1, test_frac=0.0, seed=42):
        self.val_frac, self.test_frac, self.seed = val_frac, test_frac, seed

    def _partition(self, all_scenes):
        scenes = sorted(str(s) for s in all_scenes)
        rng = np.random.RandomState(self.seed)
        n = len(scenes)
        order = rng.permutation(n)
        n_test = int(self.test_frac * n)
        n_val = int(self.val_frac * n)
        test = {scenes[i] for i in order[:n_test]}
        val = {scenes[i] for i in order[n_test : n_test + n_val]}
        return val, test

    def assign(self, scene_name, all_scenes):
        val, test = self._partition(all_scenes)
        if scene_name in test:
            return "test"
        if scene_name in val:
            return "val"
        return "train"


class AllInOneSplitRule(SplitRule):
    """Every scene in a single split (ETH3D: all test)."""

    def __init__(self, split="test"):
        self.split = split

    def assign(self, scene_name, all_scenes):
        return self.split


class FileListRule(SplitRule):
    """Split lists precomputed on disk (MPSD train/val npys, DL3DV
    benchmark csv). ``files`` maps split -> npy/txt path."""

    def __init__(self, files: Dict[str, str], default: str = "train"):
        self.files = files
        self.default = default
        self._cache: Optional[Dict[str, set]] = None

    def _load(self):
        if self._cache is None:
            self._cache = {}
            for split, path in self.files.items():
                path = Path(path)
                if path.suffix == ".npy":
                    names = np.load(path, allow_pickle=True)
                else:
                    names = [
                        line.strip() for line in open(path) if line.strip()
                    ]
                self._cache[split] = {str(n) for n in names}
        return self._cache

    def assign(self, scene_name, all_scenes):
        for split, names in self._load().items():
            if scene_name in names:
                return split
        return self.default


class PathPrefixRule(SplitRule):
    """Scene names carry their split as a path prefix (Spring
    "train/0001"; the named val list applies within train)."""

    def __init__(self, val=()):
        self.val = {str(v) for v in val}

    def assign(self, scene_name, all_scenes):
        prefix, _, base = scene_name.partition("/")
        if base in self.val:
            return "val"
        if prefix in ("train", "val", "test"):
            return prefix
        return "train"


def _vendored(dataset: str, fallback: Optional[SplitRule] = None) -> SplitRule:
    lists = reference_split_lists()[dataset]
    rule = NamedValTestRule(val=lists.get("val", ()), test=lists.get("test", ()))
    if fallback is None:
        return rule

    known = set()
    for key in ("train", "val", "test"):
        v = lists.get(key)
        known.update(v if isinstance(v, list) else ())
    # ids the reference enumerates but assigns to NO split (its
    # valid-sequence filter drops them): keep them out of val/test.
    dropped = set(lists.get("all", ())) - known

    class _WithFallback(SplitRule):
        def assign(self, scene_name, all_scenes):
            if scene_name in known:
                return rule.assign(scene_name, all_scenes)
            if scene_name in dropped:
                return "train"
            return fallback.assign(scene_name, all_scenes)

    return _WithFallback()


SPLIT_RULES: Dict[str, SplitRule] = {
    "ase": SeededFractionRule(val_frac=0.05),
    # Vendored reference lists (the rule output matches except one id the
    # reference's valid-sequence filter drops); hex-mod-10 rule covers
    # scenes outside the vendored enumeration.
    "blendedmvs": None,  # installed below (vendored + rule fallback)
    "co3d": SeededFractionRule(val_frac=0.05),
    "dl3dv": SeededFractionRule(val_frac=0.02),
    "dynamicreplica": SeededFractionRule(val_frac=0.05),
    "eth3d": AllInOneSplitRule("test"),
    "megadepth": NamedValTestRule(val=MEGADEPTH_VAL),
    "mpsd": SeededFractionRule(val_frac=0.05),
    "mvs_synth": SeededFractionRule(val_frac=0.05),
    "paralleldomain4d": SeededFractionRule(val_frac=0.05),
    "sailvos3d": SeededFractionRule(val_frac=0.05),
    # The reference's 80/10/10 draw is not seed-reproducible: use the
    # vendored 30-scene val/test lists verbatim (benchmark set).
    "scannetppv2": None,  # installed below (vendored)
    "spring": PathPrefixRule(val=SPRING_VAL),
    "tav2_wb": NamedValTestRule(val=TARTANAIRV2_VAL, test=TARTANAIRV2_TEST),
    "unrealstereo4k": SeededFractionRule(val_frac=0.05),
}
SPLIT_RULES["scannetppv2"] = _vendored("scannetppv2")
SPLIT_RULES["blendedmvs"] = _vendored("blendedmvs", fallback=HexMod10Rule())


def assign_split(dataset: str, scene_name: str, all_scenes: Sequence[str]) -> str:
    rule = SPLIT_RULES.get(dataset)
    if rule is None:
        rule = SeededFractionRule(val_frac=0.05)
    return rule.assign(scene_name, all_scenes)


def split_scenes(
    dataset: str, scenes: Iterable[str]
) -> Dict[str, List[str]]:
    """Partition scene names into {"train": [...], "val": [...], "test": [...]}."""
    scenes = sorted(str(s) for s in scenes)
    out: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    for s in scenes:
        out[assign_split(dataset, s, scenes)].append(s)
    return out
