"""Data parallelism over the mapper's keyframe window (`parallel: {dp: N}`):
one process per dp rank, see `mesh.py`."""
