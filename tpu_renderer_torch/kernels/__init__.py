"""Device stages of the PyTorch port: vertex setup, binning + raster (two
hand-written CUDA kernels with plain PyTorch twins), deferred shading."""
