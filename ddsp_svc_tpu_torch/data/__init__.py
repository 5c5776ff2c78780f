"""The silence slicer (numpy)."""
