"""DASE core, serving side: params, component contracts, Engine, deploy."""
