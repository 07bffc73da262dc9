"""``quasi-mcp-flow-cuda``'s plain twin: push-relabel as torch ops on the CPU."""


def make():
    from genome_downsampler_tpu_torch.solvers.push_relabel import QuasiMcpPushRelabelSolver

    return QuasiMcpPushRelabelSolver("cpu")
