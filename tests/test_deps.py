"""The render and train path needs only JAX, numpy and optax: no flax, orbax,
PyYAML or PIL.  Also the YAML subset reader against PyYAML, and where the
compile cache goes."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from mini3dgs_tpu.config import parse_yaml
from mini3dgs_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parent.parent

BLOCKED = r"""
import sys
for name in ("flax", "orbax", "orbax.checkpoint", "yaml", "PIL"):
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {root!r})
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import mini3dgs_tpu
from mini3dgs_tpu.config import ConfigManager, TrainingConfig
from mini3dgs_tpu.data.dataset import RandomDataset
from mini3dgs_tpu.checks import population
from mini3dgs_tpu.train.trainer import GaussianTrainer

cfg = ConfigManager.load_from_yaml({root!r} + "/configs/synthetic_smoke.yaml")
cfg = TrainingConfig(capacity=512, image_height=32, image_width=32,
                     max_instances=4096, gaussian_chunk=32, iterations=2,
                     log_interval=1, eval_interval=10, save_interval=10,
                     output_path={out!r})
ds = RandomDataset(n_cameras=2, width=32, height=32)
ds.load_cameras()
g, _ = population(512, 200, 32, 32)
tr = GaussianTrainer(cfg)
tr.setup(dataset=ds, gaussians=g)
m = tr.train()
assert np.isfinite(float(m["total_loss"]))
tr.save_checkpoint(tr.iteration)
xyz = np.asarray(tr.state.gaussians.xyz)
tr.load_checkpoint(tr.iteration)
assert np.array_equal(np.asarray(tr.state.gaussians.xyz), xyz)
for name in ("flax", "orbax", "yaml", "PIL"):
    assert sys.modules.get(name) is None, name
print("BLOCKED-DEPS OK")
"""


def test_train_and_checkpoint_without_optional_packages(tmp_path):
    script = tmp_path / "blocked.py"
    script.write_text(BLOCKED.format(root=str(ROOT),
                                     out=str(tmp_path / "run")))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, cwd=str(tmp_path), env=env, timeout=600)
    out = p.stdout + p.stderr
    assert p.returncode == 0 and "BLOCKED-DEPS OK" in out, out[-3000:]


@pytest.mark.parametrize("name", sorted(
    p.name for p in (ROOT / "configs").glob("*.yaml")))
def test_configs_parse_like_pyyaml(name):
    yaml = pytest.importorskip("yaml")
    text = (ROOT / "configs" / name).read_text()
    assert parse_yaml(text) == yaml.safe_load(text)


def test_yaml_subset_scalars_like_pyyaml():
    yaml = pytest.importorskip("yaml")
    text = ("a: 1e-5\nb: 1.0e-5\nc: yes\nd: ~\ne: 'it''s'\n"
            "f: \"x # y\"  # note\ng:\nh: [1, 2.5, \"s\", true, -3]\n"
            "i:\n  j:\n    k: .inf\n  l: off\n")
    assert parse_yaml(text) == yaml.safe_load(text)


def test_yaml_subset_rejects_block_sequences():
    with pytest.raises(ValueError, match="unsupported YAML"):
        parse_yaml("a:\n  - 1\n  - 2\n")


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_var_wins(monkeypatch, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()
