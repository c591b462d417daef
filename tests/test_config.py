"""Config system tests: flat and nested YAML loading (reference B15 fixed),
save/load round-trip, defaults parity with the reference hyperparameters."""

import dataclasses

import pytest

from mini3dgs_tpu.config import ConfigManager, TrainingConfig


def test_defaults_match_reference():
    c = TrainingConfig()
    # reference config/config.py:41-64
    assert c.iterations == 30000
    assert c.position_lr_init == 0.00016
    assert c.position_lr_final == 0.0000016
    assert c.feature_lr == 0.0025
    assert c.opacity_lr == 0.05
    assert c.scaling_lr == 0.005
    assert c.rotation_lr == 0.001
    assert c.densify_from_iter == 500
    assert c.densify_until_iter == 15000
    assert c.densify_grad_threshold == 0.0002
    assert c.densify_interval == 100
    assert c.image_height == 800
    assert c.lambda_dssim == 0.2


def test_nested_yaml_loads(tmp_path):
    """The reference's nested default.yaml layout must load (B15 fixed)."""
    yaml_text = """
data:
  path: "my/scene"
  output_path: "out"
training:
  iterations: 123
  eval_interval: 5
learning_rates:
  position:
    init: 0.001
    final: 0.00001
    max_steps: 123
  feature: 0.9
density_control:
  densify_interval: 7
rendering:
  image_height: 64
  image_width: 32
  background_color: [1.0, 1.0, 1.0]
loss:
  lambda_dssim: 0.5
system:
  device: "gpu"
"""
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml_text)
    c = ConfigManager.load_from_yaml(str(p))
    assert c.data_path == "my/scene"
    assert c.output_path == "out"
    assert c.iterations == 123
    assert c.eval_interval == 5
    assert c.position_lr_init == 0.001
    assert c.position_lr_max_steps == 123
    assert c.feature_lr == 0.9
    assert c.densify_interval == 7
    assert c.image_height == 64
    assert c.image_width == 32
    assert c.background_color == [1.0, 1.0, 1.0]
    assert c.lambda_dssim == 0.5


def test_flat_yaml_loads(tmp_path):
    p = tmp_path / "flat.yaml"
    p.write_text("iterations: 42\nopacity_lr: 0.1\n")
    c = ConfigManager.load_from_yaml(str(p))
    assert c.iterations == 42
    assert c.opacity_lr == 0.1


def test_save_load_roundtrip(tmp_path):
    c = TrainingConfig(iterations=7, capacity=64, color_mode="sh")
    path = str(tmp_path / "saved.yaml")
    ConfigManager.save_to_yaml(c, path)
    c2 = ConfigManager.load_from_yaml(path)
    assert c2 == c


def test_repo_default_yaml_loads():
    c = ConfigManager.load_from_yaml("configs/default.yaml")
    assert c.iterations == 30000
    assert c.capacity == 131072
    assert c.use_pallas is True
