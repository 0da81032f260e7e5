"""The plain reference: the scene and the renderer's outputs worked out
again in plain PyTorch and NumPy, with nothing of the renderer under test."""
