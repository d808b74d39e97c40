"""Preset files, the flat preset parser, the backend policy, and where the
compile cache goes."""

import os
import subprocess
import sys

import pytest

from unified_cvo_tpu.config import (PRESET_DIR, CvoParams, load_preset,
                                    parse_flat_params, preset_path,
                                    read_cvo_params_yaml)
from unified_cvo_tpu.models.align import resolve_backend, resolve_nl_builder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(f[:-5] for f in os.listdir(PRESET_DIR) if f.endswith(".yaml"))


@pytest.mark.parametrize("name", PRESETS)
def test_preset_loads_and_names_its_source(name):
    """Every in-repo preset parses, sets only known fields, and its header
    names its upstream file and lists the hand-set values under
    `assumed`."""
    text = open(preset_path(name)).read()
    assert text.startswith("%YAML:1.0\n---\n")
    assert f"cvo_params/{name}.yaml" in text
    assert "# assumed:" in text
    data = parse_flat_params(text)
    fields = {f for f in CvoParams.__dataclass_fields__}
    assert set(data) <= fields, set(data) - fields
    lines = text.splitlines()
    block = lines[lines.index("# assumed:") + 1:]
    assumed = []
    for ln in block:
        if not ln.startswith("#   "):
            break
        assumed += ln[1:].split()
    assert set(data) <= set(assumed), set(data) - set(assumed)
    p = load_preset(name)
    for key, value in data.items():
        assert getattr(p, key) == pytest.approx(float(value)), key


def test_preset_names_cover_the_callers():
    for name in ("cvo_geometric_params_img_gpu0",
                 "cvo_intensity_params_img_gpu0", "cvo_rgbd_params",
                 "cvo_outdoor_params", "cvo_intensity_params_irls_tum",
                 "cvo_semantic_params_img_gpu0"):
        assert name in PRESETS
    assert preset_path("cvo_rgbd_params.yaml") == preset_path("cvo_rgbd_params")
    with pytest.raises(FileNotFoundError, match="known"):
        preset_path("no_such_preset")


@pytest.mark.parametrize("text,want", [
    ("%YAML:1.0\n---\nell_init: 0.25\n", {"ell_init": 0.25}),
    ("ell_init: 0.25  # trailing comment\n\n# whole-line comment\n",
     {"ell_init": 0.25}),
    ("MAX_ITER: 700\nis_using_intensity: True\nis_using_geometry: False\n",
     {"MAX_ITER": 700, "is_using_intensity": "True",
      "is_using_geometry": "False"}),
    ("eps_2: 1.2e-5\nsp_thres: '0.003'\n", {"eps_2": 1.2e-5, "sp_thres": 0.003}),
])
def test_parse_flat_params(text, want):
    assert parse_flat_params(text) == want


def test_read_params_opencv_words_and_unknown_keys(tmp_path):
    path = tmp_path / "p.yaml"
    path.write_text("%YAML:1.0\n---\nis_using_intensity: True\n"
                    "is_using_geometry: false\nMAX_ITER: 12\nell_init: 1\n"
                    "not_a_field: 3\n")
    p = read_cvo_params_yaml(str(path))
    assert p.is_using_intensity == 1 and p.is_using_geometry == 0
    assert p.MAX_ITER == 12 and isinstance(p.ell_init, float)
    assert p.sigma == CvoParams().sigma       # missing keys keep defaults


def test_parse_flat_params_rejects_malformed_line():
    with pytest.raises(ValueError, match="line 2"):
        parse_flat_params("ell_init: 0.5\njust words\n")


@pytest.mark.parametrize("cap,flags,want", [
    (16384, {}, "ell"),
    (4096, dict(is_using_geometry=0, is_using_intensity=1), "ell"),
    (2048, {}, "jnp"),
    (16384, dict(is_ell_adaptive=1, is_using_geometry=0,
                 is_using_intensity=1), "jnp"),
    (16384, dict(is_using_geometry=0), "jnp"),
])
def test_resolve_backend_ell_or_jnp(cap, flags, want):
    """The auto policy returns 'ell' or 'jnp' from the configuration and
    sizes alone."""
    p = CvoParams(**flags)
    assert resolve_backend(p, cap, cap) == want


def test_resolve_backend_ignores_platform(monkeypatch):
    import jax

    p = load_preset("cvo_geometric_params_img_gpu0")
    here = [resolve_backend(p, c, c) for c in (1024, 16384)]
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert [resolve_backend(p, c, c) for c in (1024, 16384)] == here
    assert resolve_backend(p, 16384, 16384, "jnp") == "jnp"
    for gone in ("pallas", "fused"):
        with pytest.raises(ValueError, match="unknown backend"):
            resolve_backend(p, 16384, 16384, gone)
    assert resolve_nl_builder(p, 16384, 16384) == "grid"
    assert resolve_nl_builder(p.replace(ell_init=5.0), 16384, 16384) == "scan"


def _cache_dir(env_update):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "UNIFIED_CVO_NO_COMPILE_CACHE")}
    env.update(env_update, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax, unified_cvo_tpu\n"
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=300, cwd="/")
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_inside_checkout_when_unset():
    got = _cache_dir({})
    assert got == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_follows_environment(tmp_path):
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == \
        str(tmp_path)
