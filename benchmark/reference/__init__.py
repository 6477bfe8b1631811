"""The plain reference the benchmark judges the program's images by: plain
PyTorch in float64, with every table lookup as plain indexing (gather.py).
A frozen copy of the plain path of the renderer; it imports nothing of
the program it judges, and takes from the benchmark only the generated
data and the camera's parameters (render.py)."""
