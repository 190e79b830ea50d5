"""The port's YAML subset parser and config composition against PyYAML and the JAX package.

The parser against ``yaml.safe_load`` on every file under configs/ (walked in
one test) and on scalars that YAML 1.1 resolves in surprising ways; it raises
on what is outside its subset. ``load_config`` against the JAX package's on
the train, finetune, inference and three benchmark configs, as they stand, with
dotted overrides (a value that reads as a float, a flow list, a DSL string
with interpolations) and with group swaps. Equality is exact (``repr``, so
an int is not a float).
"""

import math
from pathlib import Path

import pytest
import yaml

from mapanything_tpu.utils import config as jax_config
from mapanything_tpu_torch.utils import config as port_config
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils import yaml_subset

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"


def test_every_config_file_parses_as_pyyaml_does():
    files = sorted(CONFIGS.rglob("*.yaml"))
    assert len(files) >= 170
    for path in files:
        want = yaml.safe_load(path.read_text())
        got = yaml_subset.load_file(path)
        assert repr(got) == repr(want), path.relative_to(ROOT)


SCALARS = ["5e-5", "1.0e-4", "1.0e4", "1.5e+3", "-1", "+12", "-0", "0.", ".5", "0x1F", "017", "0b101", "1:30",
           "1:30.5", "1_000", "3.14_15", ".inf", "-.inf", "+.INF", "yes", "Off", "TRUE", "NO", "~", "null", "",
           "'a''b'", '"a\\tb\\u00e9"', "'[(518, 518), (518, 392)]'", "[1, [2, 3], {a: b}]", "{a: 1, b: [x, 'y, z']}",
           "16 @ ${dataset.eth3d}", '${special_float:"-inf"}', "ETH3DWAI(split='train', num_views=4)"]
DOCUMENTS = [
    "a: 1\nb:\n  - x\n  - y: 2\n    z: 3\nc:\n- 1\n- 2\n",
    "k: \"multi\n  line\n\n  three\"  # comment\n",
    "x: 1 # c\ny: 'a # b' # c\nz: a#b\n",
    "- a\n- - b\n  - c\n-\n  - d\n",
    "a:\n  b:\n    c: 1\n\n  # a comment\n  d: 2\ne:\n",
    "'quoted key': 1\n\"other\": [a, b]\n",
]


@pytest.mark.parametrize("text", SCALARS + DOCUMENTS)
def test_scalars_and_documents_parse_as_pyyaml_does(text):
    want, got = yaml.safe_load(text), yaml_subset.loads(text)
    assert repr(got) == repr(want) or (isinstance(want, float) and math.isnan(want) and math.isnan(got))


@pytest.mark.parametrize("text", ["a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x", "a: b\n  c",
                                  "a: [1,\n  2]", "---\na: 1", "t: 2001-12-14", "<<: x", "a:\n\t- 1", "a: b: c"])
def test_constructs_outside_the_subset_raise(text):
    with pytest.raises(yaml_subset.YamlSubsetError):
        yaml_subset.loads(text)


OVERRIDES = [
    [],
    ["train_params.lr=5e-5", "train_params.epochs=3", "dataset.num_views=4", "model.info_sharing.indices=[1, 2]",
     "dataset.train_dataset=16 @ ${dataset.eth3d_wai.train.dataset_str}", "dataset.resolution_train="
     "${dataset.resolution_options.518_many_ar}", "machine.root_data_dir=/data/wai", "new.key=on"],
    ["dataset=megatrain_6d_518_many_ar_48ipg_8g", "machine=local", "model=pi3", "loss=pi3_loss",
     "train_params=freeze_encoder", "distributed.accum_iter=4"],
]


@pytest.mark.parametrize("overrides", range(len(OVERRIDES)))
@pytest.mark.parametrize("name", ["train", "finetune", "inference", "dense_n_view_benchmark", "rmvd_benchmark",
                                  "calibration_benchmark"])
def test_load_config_matches_jax(name, overrides):
    path, ov = CONFIGS / f"{name}.yaml", OVERRIDES[overrides]
    want = jax_config.load_config(path, overrides=ov)
    got = port_config.load_config(path, overrides=ov)
    assert repr(got) == repr(want)
    if overrides == 1 and name in ("train", "finetune"):  # the configs that compose the WAI datasets
        assert got["train_params"]["lr"] == 5e-5 and got["dataset"]["train_dataset"].startswith("16 @ ETH3DWAI(")


def test_interpolation_helpers_match_jax():
    cfg = {"a": {"b": 2, "s": "x${a.b}y", "inf": '${special_float:"-inf"}'}, "c": "${a.b}", "d": "${missing.key}"}
    assert repr(port_config.resolve_interpolations(cfg)) == repr(jax_config.resolve_interpolations(cfg))
    base, over = {"a": {"b": 1, "c": [1]}, "d": 1}, {"a": {"c": [2], "e": 3}}
    assert port_config.deep_merge(base, over) == jax_config.deep_merge(base, over)
