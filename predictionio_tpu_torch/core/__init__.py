"""DASE core: params, component contracts, Engine (train), deploy."""
