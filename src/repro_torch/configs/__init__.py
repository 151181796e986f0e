"""Assigned architecture configs (public literature) + the paper's GPT-2
workload, as the JAX package's `repro.configs` lists them.

Importing this package registers every architecture with
`repro_torch.config`.
"""
from repro_torch.configs import (  # noqa: F401
    hubert_xlarge,
    llama3_2_1b,
    olmo_1b,
    h2o_danube3_4b,
    smollm_135m,
    mamba2_2p7b,
    zamba2_7b,
    pixtral_12b,
    deepseek_v2_236b,
    arctic_480b,
    gpt2,
)

ASSIGNED = [
    "hubert-xlarge",
    "llama3.2-1b",
    "olmo-1b",
    "h2o-danube-3-4b",
    "smollm-135m",
    "mamba2-2.7b",
    "zamba2-7b",
    "pixtral-12b",
    "deepseek-v2-236b",
    "arctic-480b",
]
