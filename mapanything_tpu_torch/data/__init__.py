"""Data of the port: datasets, samplers, the loader, WAI scene IO, splits, transforms, crop and resize."""
