"""The plain reference the benchmark holds the program to.

Plain numpy and PyTorch, written from the published descriptions (torch-hub
DINOv2, Pillow's resampler, the D3Fields reference's ``fusion.py``),
importing nothing of the program: it works every derived quantity out
again from the inputs the benchmark makes.
"""
