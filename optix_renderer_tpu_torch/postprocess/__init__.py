"""Post-processing on the device: the à-trous denoiser and the ratio combine.

Image IO and tone mapping are the JAX package's numpy-only
``optix_renderer_tpu.postprocess.io``.
"""
