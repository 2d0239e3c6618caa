"""Auxiliary subsystems: logging, plan cloning, descriptor serialization,
device-info (reference print_device_info.cpp analogue)."""

import json
import logging

import numpy as np

import oracle
from portfft_tpu import Descriptor, Direction
from portfft_tpu.utils import logging as pl


def test_descriptor_round_trip_serialization():
    d = Descriptor(
        lengths=[16, 32],
        number_of_transforms=4,
        forward_scale=2.0,
        forward_offset=7,
    )
    d2 = Descriptor.from_dict(json.loads(json.dumps(d.to_dict())))
    assert d2.to_dict() == d.to_dict()
    assert d2.lengths == [16, 32]
    assert d2.precision == np.float32


def test_clone_shares_plan_and_computes():
    desc = Descriptor(lengths=[64], number_of_transforms=2)
    plan = desc.commit()
    c = plan.clone()
    assert c.plans is plan.plans
    assert c._bank_arrays is plan._bank_arrays
    x = oracle.gen_input(desc, 0)
    ref = oracle.reference_output(desc, x, Direction.FORWARD)
    flat = oracle.materialize(desc, x, Direction.FORWARD)
    out = np.asarray(c.compute_forward(flat))
    oracle.verify(desc, out, ref, Direction.FORWARD, check_padding=False)


def test_trace_logging_toggles(monkeypatch, caplog):
    # flags are import-time; exercise the runtime predicates directly
    monkeypatch.setattr(pl, "TRACES_ENABLED", True)
    monkeypatch.setattr(pl, "WARNINGS_ENABLED", True)
    with caplog.at_level(logging.DEBUG, logger="portfft_tpu"):
        pl.trace("hello", 42)
        pl.warn("watch out")
    assert any("hello 42" in r.message for r in caplog.records)
    assert any("watch out" in r.message for r in caplog.records)


def test_function_entry_decorator_passthrough():
    @pl.log_function_entry
    def f(a, b=1):
        return a + b

    assert f(2, b=3) == 5


def test_profiler_trace_noop():
    with pl.profiler_trace("block"):
        pass


def test_device_info_logged():
    # reference prints device caps as a "test" so ctest logs the environment
    import jax

    from portfft_tpu import resolve_device_config

    cfg = resolve_device_config()
    d = jax.devices()[0]
    print(
        f"device={getattr(d, 'device_kind', '?')} platform={d.platform} "
        f"config={cfg}"
    )
    assert cfg.max_factor == 128
