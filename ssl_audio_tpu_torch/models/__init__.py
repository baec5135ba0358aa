"""Encoders of the port: AudioNTT2022 (with SE blocks), the ResNets and the
ViT family, their heads, BatchNorm and the bf16 compute mode."""
