"""Scripts of the port that run on the card (python3 -m ssl_audio_tpu_torch.tools.<name>)."""
