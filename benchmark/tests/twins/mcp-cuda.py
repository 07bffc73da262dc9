"""``mcp-cuda``'s plain twin: kernel A's torch version on the CPU (the dense
engine at the tiny sizes), then the same host reconstruct."""


def make():
    from genome_downsampler_tpu_torch.solvers.device_sweep import McpDeviceSweepSolver

    return McpDeviceSweepSolver("cpu")
