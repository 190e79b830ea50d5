"""Data of the port: image crop and resize with intrinsics bookkeeping."""
