"""The port's config layer (biomedkg_tpu_torch/config.py) against the JAX
package's: its YAML reader against PyYAML's ``safe_load`` on every file
under configs/, the composed configs of every root config with no
overrides and with every script's override list (read from the scripts
themselves), the override grammar, and ``instantiate`` building the
port's data module without importing the JAX package."""

import glob
import os
import re
import subprocess
import sys
import textwrap

import pytest
import yaml

from biomedkg_tpu import config as jax_config
from biomedkg_tpu_torch import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
YAML_FILES = sorted(os.path.relpath(p, CONFIGS) for p in glob.glob(
    os.path.join(CONFIGS, "**", "*.yaml"), recursive=True))


def script_overrides(script: str, **variables) -> list:
    """The arguments ``scripts/<script>`` passes to its entry point, the
    shell's own expansion of them, with ``variables`` set first."""
    with open(os.path.join(ROOT, "scripts", script)) as f:
        text = f.read()
    for name, value in variables.items():
        text, n = re.subn(rf'^{name}=.*$', f'{name}="{value}"', text,
                          flags=re.M)
        assert n == 1, name
    text, n = re.subn(r"^python3 \S+\.py", "printf '%s\\n'", text,
                      flags=re.M)
    assert n == 1
    out = subprocess.run(["bash", "-c", text], capture_output=True,
                         text=True, check=True).stdout
    return out.splitlines()


OVERRIDES = {
    "none": [],
    "gcl.sh": script_overrides("gcl.sh"),
    "kge.sh random": script_overrides("kge.sh", NODE_INIT_METHOD="random"),
    "kge.sh lm": script_overrides("kge.sh", NODE_INIT_METHOD="lm"),
    "kge.sh gcl": script_overrides("kge.sh", NODE_INIT_METHOD="gcl"),
    "test_kge.sh": script_overrides("test_kge.sh"),
}


def test_script_overrides_are_the_scripts():
    assert "model.fuse_method=attention" in OVERRIDES["gcl.sh"]
    assert "devices=[0]" in OVERRIDES["gcl.sh"]
    assert {"data.embed_dim=256", "model.in_dim=256",
            "data.node_init_method=gcl"} <= set(OVERRIDES["kge.sh gcl"])
    assert "data.embed_dim=768" in OVERRIDES["kge.sh lm"]
    assert "pretrained_path=ckpt/kge/best.ckpt" in OVERRIDES["test_kge.sh"]


@pytest.mark.parametrize("name", YAML_FILES)
def test_reader_equals_safe_load(name):
    with open(os.path.join(CONFIGS, name)) as f:
        text = f.read()
    assert config.load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("overrides", sorted(OVERRIDES))
@pytest.mark.parametrize("root", ["kge", "gcl", "dpi"])
def test_composed_config_equals_jax(root, overrides):
    argv = OVERRIDES[overrides]
    got = config.load_config(CONFIGS, root, argv).to_dict()
    assert got == jax_config.load_config(CONFIGS, root, argv).to_dict()


SCALARS = [
    "a: 0,1", "a: none", "a: null", "a: ~", "a:", "a: 0.001", "a: 1e-3",
    "a: 1.0e-3", "a: yes", "a: Off", "a: 'it''s'  # note",
    'a: "x\\ty" # note', "a: it's plain", "a: Gene Name", "a: 08",
    "a: .inf", "a: -.inf", "a: -.5", "a: +12", "a: 1_000", "a: 1.5e+3",
    "a: b#c", "'q k': v", "1: one", "a: ''",
    "a: [x, 'y', \"z w\", 1, 1.5, null, [2, 3], {k: v}]",
    "a: {x: 1, y: [2, 3], z:}", "a:\n- data: dpi\n- _self_\n- x: 1\n  y: 2",
    "a:\n  - 1\n  -\n    - 2\n  - - 3\n    - 4",
    "a:\n  b:\n    c: 1  # deep\n  d: 2\ne: 3",
    "- a\n- b: c\n  d: e", "# only a comment\n", "",
]


@pytest.mark.parametrize("text", SCALARS)
def test_reader_resolves_as_safe_load(text):
    assert config.load_yaml(text) == yaml.safe_load(text)


VALUES = ["1e-3", "0.001", "10", "[0]", "[drug, disease]", "{a: 1}", "'x'",
          '"y"', "on", "0,1", "3:04", "none", "None", "null", "~", "true",
          "False", "[bad", "1_000", "inf", "'a' b", "gene/protein", ""]


@pytest.mark.parametrize("value", VALUES)
def test_override_values_equal_jax(value):
    assert config._parse_value(value) == jax_config._parse_value(value)


def _grammar_dir(tmp_path):
    d = tmp_path / "configs"
    if d.exists():
        return d
    (d / "data").mkdir(parents=True)
    (d / "main.yaml").write_text(
        "defaults:\n  - data: a\nlr: 0.1\nextra: 1\nlist: [1, 2]\n")
    (d / "data" / "a.yaml").write_text("name: a\nonly_a: 1\n")
    (d / "data" / "b.yaml").write_text("name: b\n")
    return d


GRAMMAR = {
    "scientific float": ["lr=1e-3"],
    "yaml 1.1 bool stays a string": ["sw=on"],
    "delete": ["~extra"],
    "delete with a value": ["~extra=1"],
    "add": ["+new.key=5"],
    "group selection": ["data=b"],
    "group key": ["data.name=c"],
    "flow list": ["list=[3, 'x', [4]]"],
    "flow map": ["data={name: m, k: [1]}"],
    "all": ["lr=1e-3", "sw=on", "~extra", "data=b", "+new=[a, b]"],
}


@pytest.mark.parametrize("case", sorted(GRAMMAR))
def test_override_grammar_equals_jax(case, tmp_path):
    d = _grammar_dir(tmp_path)
    got = config.load_config(d, "main", GRAMMAR[case])
    assert got.to_dict() == jax_config.load_config(
        d, "main", GRAMMAR[case]).to_dict()


def test_override_grammar_semantics(tmp_path):
    cfg = config.load_config(_grammar_dir(tmp_path), "main",
                             ["lr=1e-3", "sw=on", "~extra", "data=b"])
    assert isinstance(cfg.lr, float) and abs(cfg.lr - 1e-3) < 1e-12
    assert cfg.sw == "on" and "extra" not in cfg
    assert cfg.data.name == "b" and "only_a" not in cfg.data
    with pytest.raises(ValueError, match="Malformed"):
        config.load_config(_grammar_dir(tmp_path), "main", ["bare"])


def test_config_dir_resolves_from_any_directory(tmp_path, monkeypatch):
    """A relative ``configs`` the working directory lacks is the
    repository's."""
    monkeypatch.chdir(tmp_path)
    cfg = config.load_config("configs", "kge", ["seed=3"])
    assert cfg.seed == 3 and cfg.data.embed_dim == 768
    assert config.resolve_config_dir("configs") == config.REPO_ROOT / \
        "configs"


def test_cli_overrides_and_main(monkeypatch):
    assert config.cli_overrides(["--flag", "a=1", "~b", "c"]) == ["a=1",
                                                                 "~b"]
    monkeypatch.setattr(sys, "argv", ["x", "epochs=3", "--v"])
    seen = []
    config.main(config.CONFIG_DIR, "gcl")(seen.append)()
    assert seen[0].epochs == 3 and seen[0].model.model_name == "ggd"


REFUSED = ["a: 2001-12-14", "a: &x 1", "a: |\n  b", "a: b\n  c",
           "---\na: 1\n---\nb: 2", "a: 0x1F", "a: 017", "a: 0b101",
           "a: 1:30", "a: 190:20:30.15", 'a: "\\x41"', 'a: "\\u00e9"',
           'a: "\\N"']


@pytest.mark.parametrize("text", REFUSED)
def test_reader_refuses_what_it_does_not_read(text):
    """Forms that no config uses raise, rather than being read otherwise
    than safe_load reads them."""
    with pytest.raises(config.YAMLError):
        config.load_yaml(text)


_CHILD = textwrap.dedent("""
    import sys
    for name in ("jax", "biomedkg_tpu", "yaml", "pandas"):
        sys.modules[name] = None
    from biomedkg_tpu_torch import config
    cfg = config.load_config("configs", "kge", ["data.batch_size=16"])
    assert cfg.data._target_ == "biomedkg_tpu.data.modules.PrimeKGModule"
    dm = config.instantiate(cfg.data, gcl_model=cfg.gcl_model,
                            gcl_fuse_method=cfg.gcl_fuse_method, seed=3)
    assert type(dm).__module__ == "biomedkg_tpu_torch.data.modules", type(dm)
    assert dm.batch_size == 16 and dm.seed == 3
    dpi = config.instantiate(config.load_config("configs", "dpi").data,
                             seed=3)
    assert type(dpi).__name__ == "DPIModule", type(dpi)
    assert type(dpi).__module__ == "biomedkg_tpu_torch.data.modules"
    assert dpi.data_dir == "./data/dpi/dpi_benchmark.csv" and dpi.seed == 3
    print(sorted(m for m, mod in sys.modules.items() if mod is not None
                 and m.split(".")[0] in ("jax", "biomedkg_tpu", "yaml")))
""")


def test_instantiate_builds_the_port_module_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    assert config.port_target("biomedkg_tpu.x.Y") == "biomedkg_tpu_torch.x.Y"
    assert config.port_target("collections.OrderedDict") == \
        "collections.OrderedDict"
