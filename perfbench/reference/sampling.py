"""Per-location fault bits -> syndromes and true logical effects.

A trial's randoms are per gate location: ``err`` (an error happened),
``pauli`` (0, 1, 2 = X, Y, Z at an idle location) and ``cat2`` (one of the
15 two-qubit Paulis at a CNOT, in the order of the circuit noise model:
X/Y/Z on the control, X/Y/Z on the target, XX, YY, ZZ, XY, YX, YZ, ZY, XZ,
ZX). An elementary location of a decoding basis flips that basis's frame
when its gate location erred and its Pauli has the basis's component: Y or
Z for the Z frame, X or Y for the X frame; a measurement or preparation
location flips it whenever it errs. The augmented signature (syndrome rows,
then logical rows) is the XOR of the signature columns of the flipped
locations' fault classes.
"""
from __future__ import annotations

import numpy as np
import torch

# (control, target) Pauli of each two-qubit category
TWO_QUBIT = ("XI", "YI", "ZI", "IX", "IY", "IZ", "XX", "YY", "ZZ",
             "XY", "YX", "YZ", "ZY", "XZ", "ZX")
SINGLE = "XYZ"
ROLE_SINGLE, ROLE_CTRL, ROLE_TGT = 0, 1, 2


def _flips(paulis: str, basis: str) -> np.ndarray:
    """Whether each Pauli of ``paulis`` flips the ``basis`` frame."""
    comp = "YZ" if basis == "Z" else "XY"
    return np.array([p in comp for p in paulis])


class Signatures:
    """One basis's sampling tables on a device.

    gate_loc, role, cls: per elementary location, its gate location, its
    role (single qubit, CNOT control leg, CNOT target leg) and its fault
    class; idle: per gate location, whether it is an idle; full: (R, n)
    augmented signature of each class (R = num_syn + k)."""

    def __init__(self, gate_loc, role, cls, idle, full, num_syn: int,
                 basis: str, device):
        dev = torch.device(device)
        self.basis, self.num_syn = basis, int(num_syn)
        self.gate_loc = torch.as_tensor(np.asarray(gate_loc, np.int64),
                                        device=dev)
        role = np.asarray(role)
        single_idle = (role == ROLE_SINGLE) & np.asarray(idle)[gate_loc]
        self.kind = torch.as_tensor(
            np.where(role == ROLE_CTRL, 2, np.where(
                role == ROLE_TGT, 3, np.where(single_idle, 1, 0))),
            device=dev)
        # (L, R): the signature of each elementary location's class, made
        # on the device (the host copy of a large code's would be GBs)
        full = torch.as_tensor((np.asarray(full) % 2).astype(np.uint8),
                               device=dev)
        cls = torch.as_tensor(np.asarray(cls, np.int64), device=dev)
        self.A = full[:, cls].T.to(torch.float32).contiguous()
        self.idle_lut = torch.as_tensor(_flips(SINGLE, basis), device=dev)
        self.ctrl_lut = torch.as_tensor(
            _flips("".join(p[0] for p in TWO_QUBIT), basis), device=dev)
        self.tgt_lut = torch.as_tensor(
            _flips("".join(p[1] for p in TWO_QUBIT), basis), device=dev)

    def bits(self, err, pauli, cat2) -> torch.Tensor:
        """(B, L) bool: the elementary locations flipped in each trial."""
        gl = self.gate_loc
        e = err[:, gl]
        p = pauli[:, gl].long()
        c = cat2[:, gl].long()
        hit = torch.where(
            self.kind == 0, True, torch.where(
                self.kind == 1, self.idle_lut[p], torch.where(
                    self.kind == 2, self.ctrl_lut[c], self.tgt_lut[c])))
        return e & hit

    def augmented(self, err, pauli, cat2) -> tuple:
        """(syndrome (B, num_syn), true logicals (B, k)), uint8. The float32
        product counts the flipped signatures of each row exactly (every
        count is below 2**24; TF32 is off for it)."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            counts = self.bits(err, pauli, cat2).to(torch.float32) @ self.A
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        aug = (counts.to(torch.int32) & 1).to(torch.uint8)
        return aug[:, :self.num_syn], aug[:, self.num_syn:]
