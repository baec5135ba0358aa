"""HEAR 2021 serving API of the port: conv.py for AudioNTT2022, vit.py for
the ViT family; extract_results.py aggregates per-task scores into a
results.json."""
