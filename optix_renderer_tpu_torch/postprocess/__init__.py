"""Post-processing on the device: the à-trous denoiser and the ratio combine.

Image IO and tone mapping (``io``, ``tonemap``) are numpy-only.
"""
