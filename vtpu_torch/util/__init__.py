"""The node agent's shared plumbing: the port's own copies of the JAX
package's ``vtpu/util`` modules it needs (wire types and codecs, the
Kubernetes client and its in-memory fake, the pod-annotation helpers of
Allocate, atomic durable writes, env parsing and the degraded-mode
surface). The port imports nothing of ``vtpu``; tests/test_torch_plugin.py
holds these copies to the originals."""
