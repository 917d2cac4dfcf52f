"""PyTorch + CUDA port of ``mlp_ppo_2ply_p3_tpu`` (backgammon self-play
PPO), for one NVIDIA H100.

Each sub-package mirrors its JAX counterpart module for module.  Plain
tensor code is PyTorch; the stable-compaction kernel that the JAX
package wrote in Pallas is CUDA C++ (``csrc/compaction.cu``, bound in
``ops/compaction.py``).  Entry points take an explicit ``device`` that
defaults to ``"cuda"`` and raise when no card is present; pass
``device="cpu"`` to run the plain PyTorch versions.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  A CUDA device without a card
    raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
