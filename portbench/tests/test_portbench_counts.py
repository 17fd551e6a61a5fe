"""The frozen work counts against the port's own ``tools/soap_bench``
counters, at two small shapes: a later edit to the port's counters cannot
move the benchmark's yardstick unseen."""

import pytest
import torch

from portbench.counts import soap, step


@pytest.mark.parametrize("N,K,S,lmax,nmax", [(40, 24, 1, 3, 3), (64, 48, 4, 2, 3)])
def test_soap_work_matches_port(N, K, S, lmax, nmax):
    from autoforce_tpu_torch.descriptor.soap import SoapParams
    from autoforce_tpu_torch.tools import soap_bench

    g = torch.Generator().manual_seed(N * K + S)
    rvec = 4.0 * torch.randn((N, K, 3), generator=g)
    sidx = torch.randint(-1, S + 1, (N, K), generator=g, dtype=torch.int32)
    mask = torch.rand((N, K), generator=g) < 0.7
    radii = torch.ones(S)
    rc = 6.0
    ours = soap.soap_work(rvec, sidx, mask, radii, lmax, nmax, rc)
    port = soap_bench.soap_work(rvec, sidx, mask, radii,
                                SoapParams(lmax=lmax, nmax=nmax, rc=rc))
    assert ours == port
    assert soap.TEST_OPS == soap_bench.TEST_OPS


def test_step_flops():
    assert step.gram_flops(2, 3, 5) == 120.0
    assert step.step_flops(2, 3, 5, 7, 11) == 138.0
