"""Events, the storage SPI with its MEM, SQLITE, EVLOG and PEVLOG
drivers, and the engine-facing store facade. Importing it loads no torch:
PEVLOG's spawn-started scan workers import `data.storage`."""
