"""Events, the storage SPI with its MEM and SQLITE drivers, and the
engine-facing store facade."""
