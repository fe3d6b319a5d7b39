"""Tools around the training path; so far the pose-dictionary fit over an
image tree (tools/parity.py). The data-preparation writers of the JAX
package's tools/ are not ported yet (ROADMAP.md)."""
