"""Two-view log-mel augmentations of the port (BYOL-A style), on the device."""
