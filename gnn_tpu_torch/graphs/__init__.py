"""Host graphs, datasets, dataset utilities and padded tensor batches."""
