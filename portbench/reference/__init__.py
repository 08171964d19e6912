"""The plain reference of the benchmark: the scene and its images, the
Instant-NGP field, the marcher, one training step with Adam, the
density-grid update and a view, in plain PyTorch float32. It imports
nothing of the program under test."""
