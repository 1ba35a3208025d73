"""Device-resident cuboid store, cutout engine and annotation database."""
