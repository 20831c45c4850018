"""Audio pipeline parameters: one source of truth shared with the JAX package.

`tpu_speech_commands.params` imports only the standard library, so the port
re-exports its `ListenerParams`, the global `pr` singleton and
`inject_params` instead of copying them: a config injected through either
package is seen by both.
"""
from tpu_speech_commands.params import ListenerParams, inject_params, pr

__all__ = ["ListenerParams", "inject_params", "pr"]
