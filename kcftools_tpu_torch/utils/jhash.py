"""Emulation of java.util.HashMap iteration order, including treeified
bins.

The reference's ``findIBS`` iterates chromosomes through a plain
``HashMap`` keySet (reference: Plugins/FindIBS.java:124,168), so the
output window order and IBS block numbering follow Java's hash-bucket
order rather than input order. Byte-identical replication requires
reproducing that order, which for String keys is FULLY deterministic:

* String.hashCode (31-polynomial over UTF-16 units), HashMap.hash
  spreading h ^ (h >>> 16), power-of-two tables with 0.75 load factor,
  and order-preserving lo/hi bin splits on resize (JDK 8..21 putVal /
  resize semantics).
* Treeified bins (a put walking TREEIFY_THRESHOLD-1 = 7 links with
  table length >= MIN_TREEIFY_CAPACITY = 64; smaller tables resize
  instead): iteration STILL follows the bin's linked list, which
  treeification perturbs deterministically - treeify() moves the tree
  root to the list head (moveRootToFront), later tree puts splice the
  new node right after its tree parent (putTreeVal), and resize-splits
  preserve list order, untreeifying parts that shrink to
  UNTREEIFY_THRESHOLD = 6 or fewer nodes.
* The red-black tree insert order uses the spread hash, then
  compareTo for Comparable keys, then the identityHashCode tiebreak
  (tieBreakOrder). For distinct String keys compareTo never returns 0,
  so the JVM-nondeterministic tiebreak is UNREACHABLE and the order is
  a pure function of the key strings. We raise if a caller's keys ever
  reach it (only possible for pathological non-String-like inputs).

The RB-tree code below transcribes java.util.HashMap.TreeNode's
treeify / balanceInsertion / rotateLeft / rotateRight / split /
untreeify / moveRootToFront / putTreeVal logic. Committed fixtures
(tests/fixtures/jhash_orders.json) pin the reviewed behavior so later
regressions are visible; the NON-treeified orders are additionally
cross-checked against an independent bucket model and hand-checkable
arithmetic (see the fixtures README), while the treeified orders rest
on this transcription - no JVM exists in this environment to diff
against, a limitation the README documents.
"""

import array
import functools
import sys

_INT_MASK = 0xFFFFFFFF

TREEIFY_THRESHOLD = 8
UNTREEIFY_THRESHOLD = 6
MIN_TREEIFY_CAPACITY = 64


@functools.lru_cache(maxsize=65536)
def _u16(s: str):
    """The string's UTF-16 code units (what Java's char[] holds):
    non-BMP code points become their surrogate pairs, so hashing and
    ordering match the JVM for every valid key, not just BMP ones."""
    a = array.array("H")
    a.frombytes(s.encode("utf-16-be" if sys.byteorder == "big"
                         else "utf-16-le"))
    return tuple(a)


def java_string_hash(s: str) -> int:
    # Java hashes UTF-16 code units (String.hashCode); iterating code
    # UNITS (surrogate halves for non-BMP) keeps this exact everywhere.
    h = 0
    for unit in _u16(s):
        h = (31 * h + unit) & _INT_MASK
    return h


def _spread(h: int) -> int:
    return (h ^ (h >> 16)) & _INT_MASK


class _Node:
    __slots__ = ("hash", "key", "next", "prev", "parent", "left",
                 "right", "red", "tree")

    def __init__(self, h, key, nxt=None):
        self.hash = h
        self.key = key
        self.next = nxt
        self.prev = None
        self.parent = None
        self.left = None
        self.right = None
        self.red = False
        self.tree = False


def _tie_break_order(a, b):
    # JDK tieBreakOrder: class-name compare, then identityHashCode.
    # Distinct String keys always differ under compareTo first, so
    # reaching this means the caller's keys are not plain strings.
    raise RuntimeError(
        "HashMap order emulation hit the identityHashCode tiebreak; "
        "only String-keyed maps are supported"
    )


def _compare(k, pk):
    """dir for equal-hash keys: String.compareTo compares UTF-16 code
    units, then lengths - tuple comparison over the unit sequences
    reproduces that sign exactly (incl. surrogate-pair keys, where
    Python code-point order would diverge)."""
    a, b = _u16(k), _u16(pk)
    if a < b:
        return -1
    if a > b:
        return 1
    return 0


class _JHashMap:
    """Insert-only java.util.HashMap replica (distinct String keys)."""

    def __init__(self):
        self.table = None
        self.size = 0
        self.threshold = 0

    # -- public ---------------------------------------------------------

    def put(self, key):
        h = _spread(java_string_hash(key))
        tab = self.table
        if tab is None:
            tab = self._resize()
        n = len(tab)
        i = (n - 1) & h
        p = tab[i]
        if p is None:
            tab[i] = _Node(h, key)
        elif p.tree:
            if self._put_tree_val(tab, p, h, key):
                return  # existing key: no structural change
        else:
            bin_count = 0
            while True:
                if p.hash == h and p.key == key:
                    return
                e = p.next
                if e is None:
                    p.next = _Node(h, key)
                    if bin_count >= TREEIFY_THRESHOLD - 1:
                        self._treeify_bin(h)
                    break
                p = e
                bin_count += 1
        self.size += 1
        if self.size > self.threshold:
            self._resize()

    def iter_keys(self):
        tab = self.table or []
        for head in tab:
            e = head
            while e is not None:
                yield e.key
                e = e.next

    # -- table management ----------------------------------------------

    def _resize(self):
        old = self.table
        old_cap = len(old) if old else 0
        if old_cap == 0:
            new_cap, self.threshold = 16, 12
            self.table = [None] * new_cap
            return self.table
        new_cap = old_cap * 2
        self.threshold *= 2
        new_tab = [None] * new_cap
        self.table = new_tab
        for j in range(old_cap):
            e = old[j]
            if e is None:
                continue
            old[j] = None
            if e.next is None:
                new_tab[e.hash & (new_cap - 1)] = e
            elif e.tree:
                self._split(new_tab, e, j, old_cap)
            else:
                lo_head = lo_tail = hi_head = hi_tail = None
                while e is not None:
                    nxt = e.next
                    if e.hash & old_cap:
                        if hi_tail is None:
                            hi_head = e
                        else:
                            hi_tail.next = e
                        hi_tail = e
                    else:
                        if lo_tail is None:
                            lo_head = e
                        else:
                            lo_tail.next = e
                        lo_tail = e
                    e = nxt
                if lo_tail is not None:
                    lo_tail.next = None
                    new_tab[j] = lo_head
                if hi_tail is not None:
                    hi_tail.next = None
                    new_tab[j + old_cap] = hi_head
        return new_tab

    def _treeify_bin(self, h):
        tab = self.table
        n = len(tab)
        if n < MIN_TREEIFY_CAPACITY:
            self._resize()
            return
        index = (n - 1) & h
        e = tab[index]
        if e is None:
            return
        # convert to tree nodes (list preserved), set prev links
        hd = e
        prev = None
        while e is not None:
            e.tree = True
            e.parent = e.left = e.right = None
            e.red = False
            e.prev = prev
            prev = e
            e = e.next
        tab[index] = hd
        self._treeify(tab, hd)

    # -- TreeNode logic (java.util.HashMap.TreeNode) --------------------

    def _treeify(self, tab, head):
        root = None
        x = head
        while x is not None:
            nxt = x.next
            x.left = x.right = None
            if root is None:
                x.parent = None
                x.red = False
                root = x
            else:
                k, h = x.key, x.hash
                p = root
                while True:
                    ph = p.hash
                    if ph > h:
                        d = -1
                    elif ph < h:
                        d = 1
                    else:
                        d = _compare(k, p.key)
                        if d == 0:
                            d = _tie_break_order(k, p.key)
                    xp = p
                    p = p.left if d <= 0 else p.right
                    if p is None:
                        x.parent = xp
                        if d <= 0:
                            xp.left = x
                        else:
                            xp.right = x
                        root = self._balance_insertion(root, x)
                        break
            x = nxt
        self._move_root_to_front(tab, root)

    def _put_tree_val(self, tab, first, h, key):
        """True when the key already exists (no insert)."""
        root = first
        while root.parent is not None:
            root = root.parent
        p = root
        while True:
            ph = p.hash
            if ph > h:
                d = -1
            elif ph < h:
                d = 1
            elif p.key == key:
                return True
            else:
                d = _compare(key, p.key)
                if d == 0:
                    d = _tie_break_order(key, p.key)
            xp = p
            p = p.left if d <= 0 else p.right
            if p is None:
                xpn = xp.next
                x = _Node(h, key, xpn)
                x.tree = True
                if d <= 0:
                    xp.left = x
                else:
                    xp.right = x
                xp.next = x
                x.parent = x.prev = xp
                if xpn is not None:
                    xpn.prev = x
                self._move_root_to_front(
                    tab, self._balance_insertion(root, x)
                )
                return False

    def _split(self, new_tab, head, index, bit):
        lo_head = lo_tail = hi_head = hi_tail = None
        lc = hc = 0
        e = head
        while e is not None:
            nxt = e.next
            e.next = None
            if e.hash & bit:
                e.prev = hi_tail
                if hi_tail is None:
                    hi_head = e
                else:
                    hi_tail.next = e
                hi_tail = e
                hc += 1
            else:
                e.prev = lo_tail
                if lo_tail is None:
                    lo_head = e
                else:
                    lo_tail.next = e
                lo_tail = e
                lc += 1
            e = nxt
        if lo_head is not None:
            if lc <= UNTREEIFY_THRESHOLD:
                new_tab[index] = self._untreeify(lo_head)
            else:
                new_tab[index] = lo_head
                if hi_head is not None:
                    self._treeify(new_tab, lo_head)
        if hi_head is not None:
            if hc <= UNTREEIFY_THRESHOLD:
                new_tab[index + bit] = self._untreeify(hi_head)
            else:
                new_tab[index + bit] = hi_head
                if lo_head is not None:
                    self._treeify(new_tab, hi_head)

    @staticmethod
    def _untreeify(head):
        e = head
        while e is not None:
            e.tree = False
            e.parent = e.left = e.right = e.prev = None
            e.red = False
            e = e.next
        return head

    def _move_root_to_front(self, tab, root):
        if root is None:
            return
        index = (len(tab) - 1) & root.hash
        first = tab[index]
        if first is not root:
            rn = root.next
            rp = root.prev
            if rn is not None:
                rn.prev = rp
            if rp is not None:
                rp.next = rn
            if first is not None:
                first.prev = root
            root.next = first
            root.prev = None
            tab[index] = root

    # RB-tree fixup, transcribed from HashMap.TreeNode.balanceInsertion
    @staticmethod
    def _rotate_left(root, p):
        if p is None:
            return root
        r = p.right
        if r is None:
            return root
        rl = p.right = r.left
        if rl is not None:
            rl.parent = p
        pp = r.parent = p.parent
        if pp is None:
            root = r
            r.red = False
        elif pp.left is p:
            pp.left = r
        else:
            pp.right = r
        r.left = p
        p.parent = r
        return root

    @staticmethod
    def _rotate_right(root, p):
        if p is None:
            return root
        l = p.left
        if l is None:
            return root
        lr = p.left = l.right
        if lr is not None:
            lr.parent = p
        pp = l.parent = p.parent
        if pp is None:
            root = l
            l.red = False
        elif pp.right is p:
            pp.right = l
        else:
            pp.left = l
        l.right = p
        p.parent = l
        return root

    @classmethod
    def _balance_insertion(cls, root, x):
        x.red = True
        while True:
            xp = x.parent
            if xp is None:
                x.red = False
                return x
            if not xp.red:
                return root
            xpp = xp.parent
            if xpp is None:
                return root
            xppl = xpp.left
            if xp is xppl:
                xppr = xpp.right
                if xppr is not None and xppr.red:
                    xppr.red = False
                    xp.red = False
                    xpp.red = True
                    x = xpp
                else:
                    if x is xp.right:
                        root = cls._rotate_left(root, xp)
                        x = xp
                        xp = x.parent
                        xpp = xp.parent if xp is not None else None
                    if xp is not None:
                        xp.red = False
                        if xpp is not None:
                            xpp.red = True
                            root = cls._rotate_right(root, xpp)
            else:
                if xppl is not None and xppl.red:
                    xppl.red = False
                    xp.red = False
                    xpp.red = True
                    x = xpp
                else:
                    if x is xp.left:
                        root = cls._rotate_right(root, xp)
                        x = xp
                        xp = x.parent
                        xpp = xp.parent if xp is not None else None
                    if xp is not None:
                        xp.red = False
                        if xpp is not None:
                            xpp.red = True
                            root = cls._rotate_left(root, xpp)


def hashmap_iteration_order(keys):
    """Return ``keys`` in the order a java.util.HashMap (default ctor)
    iterates them after inserting in the given order - including
    treeified bins (scaffold-heavy assemblies or adversarial name sets
    no longer fall back; see module docstring)."""
    m = _JHashMap()
    for key in keys:
        m.put(key)
    return list(m.iter_keys())
