"""Operator tooling: the fleet-wide SLO verdict engine (fleetmon)."""
