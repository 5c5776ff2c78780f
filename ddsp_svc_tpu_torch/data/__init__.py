"""The silence slicer, wav I/O, the training loaders and the feature
front end (f0, volume, units)."""
