"""The harness: finds a cell by name, drives the program, reads the trace, checks the result."""
