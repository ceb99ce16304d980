"""Models of the serving path: layers, ViT, transformer, parameters."""
