"""LoRA and full-parameter SFT on PyTorch: the port of ``chatts_tpu/train/``."""
