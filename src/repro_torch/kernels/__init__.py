"""Hand-written Hopper kernels of the port, each beside its plain version."""
import torch


def on_cuda(t: torch.Tensor, op: str) -> bool:
    """The one routing rule of every op: a CUDA tensor launches the kernel,
    a CPU tensor runs the plain version, any other device raises."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"{op} runs on cuda or cpu, not {t.device}")
