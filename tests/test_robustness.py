"""Executor robustness: batch chunking under lax.map."""

import dataclasses

import numpy as np
import pytest

import oracle
from portfft_tpu import Descriptor, Direction


def test_batch_chunking_matches_oracle():
    desc = Descriptor(lengths=[1024], number_of_transforms=8)
    plan = desc.commit()
    # Budget small enough for 2 transforms per chunk -> lax.map over 4 chunks
    plan.config = dataclasses.replace(
        plan.config, hbm_chunk_bytes=2 * 16 * 4 * 1024
    )
    x = oracle.gen_input(desc, 0)
    ref = oracle.reference_output(desc, x, Direction.FORWARD)
    flat = oracle.materialize(desc, x, Direction.FORWARD)
    out = np.asarray(plan.compute_forward(flat))
    oracle.verify(desc, out, ref, Direction.FORWARD, check_padding=False)


def test_batch_chunking_at_global_size():
    """The lax.map chunking path on a GLOBAL-level plan (four-step
    intermediates inside the mapped body)."""
    n = 65536
    desc = Descriptor(lengths=[n], number_of_transforms=4)
    plan = desc.commit()
    plan.config = dataclasses.replace(
        plan.config, hbm_chunk_bytes=2 * 16 * 4 * n
    )
    x = oracle.gen_input(desc, 5)
    ref = oracle.reference_output(desc, x, Direction.FORWARD)
    flat = oracle.materialize(desc, x, Direction.FORWARD)
    out = np.asarray(plan.compute_forward(flat))
    oracle.verify(desc, out, ref, Direction.FORWARD, check_padding=False)


def test_chunking_skips_non_divisible_batches():
    desc = Descriptor(lengths=[256], number_of_transforms=7)
    plan = desc.commit()
    plan.config = dataclasses.replace(plan.config, hbm_chunk_bytes=16 * 4 * 256)
    x = oracle.gen_input(desc, 1)
    ref = oracle.reference_output(desc, x, Direction.FORWARD)
    flat = oracle.materialize(desc, x, Direction.FORWARD)
    out = np.asarray(plan.compute_forward(flat))
    oracle.verify(desc, out, ref, Direction.FORWARD, check_padding=False)


def test_workspace_len_accounts_for_bluestein():
    desc = Descriptor(lengths=[65537], number_of_transforms=1)
    plan = desc.commit()
    # the padded convolution dominates (9·2^14 = 147456 ≥ 2n-1)
    conv_n = plan.plans[65537].conv.n
    assert conv_n >= 2 * 65537 - 1
    assert plan._workspace_len() >= conv_n


@pytest.mark.parametrize(
    "n,batch,rows",
    [
        # the benchmark's headline sizes (1 GiB of complex64 input each)
        # under the default 2 GiB chunk budget
        (16, 8 * 1024 * 1024, 2 * 1024 * 1024),
        (256, 512 * 1024, 128 * 1024),
        (4096, 32 * 1024, 8 * 1024),
        (65536, 2048, 512),
        # Bluestein: the padded convolution (147456) sets the working set
        (65537, 2048, 128),
        # small batches run unchunked
        (4096, 64, 64),
        (1, 1, 1),
    ],
)
def test_chunk_rows_at_bench_sizes(n, batch, rows):
    plan = Descriptor(lengths=[n], number_of_transforms=batch).commit()
    assert plan.chunk_rows(batch) == rows
    assert batch % plan.chunk_rows(batch) == 0
