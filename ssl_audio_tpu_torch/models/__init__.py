"""Encoders of the port (AudioNTT2022 so far)."""
