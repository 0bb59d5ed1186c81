"""Fault tolerance of the port: heartbeats, stragglers, restart from a
checkpoint. Elastic restore onto another mesh comes with ROADMAP A14."""
