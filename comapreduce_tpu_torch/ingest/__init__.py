"""Level-1 / Level-2 file loaders and the serial file stream."""
