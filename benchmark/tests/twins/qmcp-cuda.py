"""``qmcp-cuda``'s plain twin: the SSP kernel's torch version on the CPU."""


def make():
    from genome_downsampler_tpu_torch.solvers.device_mcmf import QmcpDeviceMcmfSolver

    return QmcpDeviceMcmfSolver("cpu")
