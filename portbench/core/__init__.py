"""The general parts of the harness: discovery by name, the closed loop,
spans, the profiler's reading, rooflines, the plain reference and the
import guard."""
