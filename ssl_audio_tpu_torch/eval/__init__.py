"""Evaluation stack of the port (port of ssl_audio_tpu/eval): the ViT's
96-frame unit splitter and embedding extraction (encode.py), the MLP probe
(mlp_clf.py), linear and low-shot evaluation (linear.py, low_shot.py), the
kNN monitor (knn.py) and the per-class statistics (stats.py, numpy and
scipy only)."""
