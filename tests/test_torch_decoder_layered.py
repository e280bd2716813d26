"""The port's BatchDecoder with the layered schedule (K3's plain version)
vs JAX's ``BatchDecoder(use_pallas=True, bp_variant="layered")`` in
interpret mode, Z-basis syndromes of [[72,12,6]] (3 cycles), through the
padding path; logicals, converged and rank_deficient exactly. One basis a
file: JAX's layered kernel takes ~35 s to compile in interpret mode.
"""
import pytest
import torch

from test_torch_decoder import (check_batch_decoder,  # noqa: F401
                                jax_kernels_interpreted, make_decoders,
                                setup72)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def layered(jax_kernels_interpreted, setup72):
    return make_decoders(*setup72, "layered")


def test_batch_decoder_layered_matches_jax_z(layered, setup72):
    check_batch_decoder(*layered, setup72[1], "Z")
