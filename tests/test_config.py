"""Precision-ladder configuration (pauxy_jax/config.py).

Each documented tier name maps onto one value of jax's
``jax_default_matmul_precision`` option; the mapping is checked against the
installed jax's own vocabulary by intercepting config.update.
"""

import jax
import pytest

from pauxy_jax import config


class _FakeConfig:
    """Records jax.config.update calls, accepting only a fixed enum set."""

    def __init__(self, accepted):
        self.accepted = accepted
        self.set = None

    def update(self, name, value):
        assert name == "jax_default_matmul_precision"
        if value not in self.accepted:
            raise ValueError(f"new enum value must be None or in "
                             f"{sorted(self.accepted)}, got {value}")
        self.set = value


@pytest.mark.unit
@pytest.mark.parametrize("policy,expect_enum", [
    ("float32", "highest"),
    ("tensorfloat32", "tensorfloat32"),
])
def test_ladder_aliases_to_available_enum(monkeypatch, policy, expect_enum):
    prev = jax.config.jax_default_matmul_precision
    try:
        # The real jax config must accept the enum this tier maps to.
        jax.config.update("jax_default_matmul_precision", expect_enum)
    finally:
        jax.config.update("jax_default_matmul_precision", prev)
    fake = _FakeConfig({expect_enum})
    monkeypatch.setattr(config.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(config.jax, "config", fake)
    assert config.set_matmul_precision(policy) == policy
    assert fake.set == expect_enum


@pytest.mark.unit
@pytest.mark.parametrize("policy", ["bfloat16_3x", "bfloat16", "bf16"])
def test_ladder_fails_loudly_when_no_tier_exists(monkeypatch, policy):
    """The bf16 tiers are refused: no setting gives correct bf16 complex64
    products on the GPU."""
    fake = _FakeConfig(set(config.MATMUL_TIERS.values()))
    monkeypatch.setattr(config.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(config.jax, "config", fake)
    with pytest.raises(ValueError, match=policy):
        config.set_matmul_precision(policy)
    assert fake.set is None


@pytest.mark.unit
def test_ladder_default_is_full_float32(monkeypatch):
    fake = _FakeConfig(set(config.MATMUL_TIERS.values()))
    monkeypatch.delenv("PAUXY_MATMUL", raising=False)
    monkeypatch.setattr(config.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(config.jax, "config", fake)
    assert config.set_matmul_precision() == "float32"
    assert fake.set == "highest"


@pytest.mark.unit
def test_cpu_is_noop():
    # The suite runs on CPU: no config mutation, full-precision answer.
    prev = jax.config.jax_default_matmul_precision
    assert config.set_matmul_precision("tensorfloat32") == "float32"
    assert jax.config.jax_default_matmul_precision == prev
