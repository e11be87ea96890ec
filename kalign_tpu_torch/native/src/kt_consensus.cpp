/* POAR consensus columns: union-find over residues with same-sequence
 * conflict + ordering-cycle rejection, then cycle-tolerant DFS topo sort.
 *
 * Exact semantics of lib/src/consensus_msa.c:12-554, including:
 *   - stable counting sort of merge candidates by descending support
 *   - bounded (4096) BFS queue during cycle checks
 *   - DFS stack discipline of the topological sort
 *
 * Input candidates must be pre-filtered by min_support and given in
 * (pair-index, key) order; this function performs the counting sort.
 * Output: for every residue (flattened by sequence), its column position
 * in the consensus alignment.  Returns the number of columns.
 */
#include "kt_api.h"

#include <cstring>
#include <vector>

namespace {

struct UF {
  std::vector<int> parent, rank_, elem_seq, set_head, next_in_set;
  std::vector<uint64_t> seq_mask; /* n * mask_words */
  int mask_words;

  int find(int x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
};

bool dag_reachable(UF& uf, int start, int target, const int* seq_offsets,
                   const int32_t* seq_lengths, std::vector<int>& visited,
                   int visit_id) {
  if (start == target) return true;
  static thread_local std::vector<int> queue;
  queue.resize(4096);
  int head = 0, tail = 0;
  queue[tail++] = start;
  visited[start] = visit_id;
  while (head < tail) {
    int cur = queue[head++];
    int elem = uf.set_head[cur];
    while (elem >= 0) {
      int s = uf.elem_seq[elem];
      int pos = elem - seq_offsets[s];
      if (pos + 1 < seq_lengths[s]) {
        int succ_root = uf.find(seq_offsets[s] + pos + 1);
        if (succ_root == target) return true;
        if (succ_root != cur && visited[succ_root] != visit_id) {
          visited[succ_root] = visit_id;
          if (tail < 4096) queue[tail++] = succ_root;
        }
      }
      elem = uf.next_in_set[elem];
    }
  }
  return false;
}

void union_safe(UF& uf, int a, int b, const int* seq_offsets,
                const int32_t* seq_lengths, std::vector<int>& visited,
                int* visit_counter) {
  int ra = uf.find(a);
  int rb = uf.find(b);
  if (ra == rb) return;
  const int mw = uf.mask_words;
  for (int w = 0; w < mw; w++) {
    if (uf.seq_mask[(size_t)ra * mw + w] & uf.seq_mask[(size_t)rb * mw + w]) {
      return; /* same-sequence conflict */
    }
  }
  (*visit_counter)++;
  if (dag_reachable(uf, ra, rb, seq_offsets, seq_lengths, visited,
                    *visit_counter)) {
    return;
  }
  (*visit_counter)++;
  if (dag_reachable(uf, rb, ra, seq_offsets, seq_lengths, visited,
                    *visit_counter)) {
    return;
  }
  int new_root, old_root;
  if (uf.rank_[ra] < uf.rank_[rb]) {
    uf.parent[ra] = rb;
    new_root = rb;
    old_root = ra;
  } else if (uf.rank_[ra] > uf.rank_[rb]) {
    uf.parent[rb] = ra;
    new_root = ra;
    old_root = rb;
  } else {
    uf.parent[rb] = ra;
    uf.rank_[ra]++;
    new_root = ra;
    old_root = rb;
  }
  for (int w = 0; w < mw; w++) {
    uf.seq_mask[(size_t)new_root * mw + w] |=
        uf.seq_mask[(size_t)old_root * mw + w];
  }
  if (uf.set_head[old_root] >= 0) {
    int tail = uf.set_head[new_root];
    if (tail < 0) {
      uf.set_head[new_root] = uf.set_head[old_root];
    } else {
      while (uf.next_in_set[tail] >= 0) tail = uf.next_in_set[tail];
      uf.next_in_set[tail] = uf.set_head[old_root];
    }
  }
  uf.set_head[old_root] = -1;
}

}  // namespace

extern "C" int32_t kt_consensus_columns(const int32_t* seq_lengths,
                                        int32_t numseq,
                                        const int64_t* cand_ei,
                                        const int64_t* cand_ej,
                                        const int32_t* cand_support,
                                        int64_t n_cand, int32_t* out_colpos) {
  std::vector<int> seq_offsets(numseq);
  int total = 0;
  for (int s = 0; s < numseq; s++) {
    seq_offsets[s] = total;
    total += seq_lengths[s];
  }
  const int mw = (numseq + 63) / 64;
  UF uf;
  uf.parent.resize(total);
  uf.rank_.assign(total, 0);
  uf.elem_seq.resize(total);
  uf.set_head.resize(total);
  uf.next_in_set.assign(total, -1);
  uf.seq_mask.assign((size_t)total * mw, 0);
  uf.mask_words = mw;
  for (int i = 0; i < total; i++) {
    uf.parent[i] = i;
    uf.set_head[i] = i;
  }
  for (int s = 0; s < numseq; s++) {
    for (int p = 0; p < seq_lengths[s]; p++) {
      int e = seq_offsets[s] + p;
      uf.elem_seq[e] = s;
      uf.seq_mask[(size_t)e * mw + s / 64] |= 1ULL << (s % 64);
    }
  }

  /* stable counting sort by descending support (values 1..32) */
  std::vector<int64_t> order(n_cand);
  {
    int counts[33] = {0};
    for (int64_t a = 0; a < n_cand; a++) counts[cand_support[a]]++;
    int offsets[33];
    offsets[32] = 0;
    for (int v = 31; v >= 0; v--) offsets[v] = offsets[v + 1] + counts[v + 1];
    for (int64_t a = 0; a < n_cand; a++) {
      order[offsets[cand_support[a]]++] = a;
    }
  }

  std::vector<int> visited(total, 0);
  int visit_counter = 0;
  for (int64_t oi = 0; oi < n_cand; oi++) {
    int64_t a = order[oi];
    union_safe(uf, (int)cand_ei[a], (int)cand_ej[a], seq_offsets.data(),
               seq_lengths, visited, &visit_counter);
  }

  /* roots -> column ids in first-seen order */
  std::vector<int> root_to_col(total, -1), col_id(total);
  int n_cols = 0;
  for (int i = 0; i < total; i++) {
    int root = uf.find(i);
    if (root_to_col[root] == -1) root_to_col[root] = n_cols++;
    col_id[i] = root_to_col[root];
  }

  /* adjacency (deduplicated in insertion order) */
  std::vector<std::vector<int>> adj(n_cols);
  for (int s = 0; s < numseq; s++) {
    int off = seq_offsets[s];
    for (int pos = 0; pos < seq_lengths[s] - 1; pos++) {
      int ca = col_id[off + pos];
      int cb = col_id[off + pos + 1];
      if (ca != cb) {
        bool dup = false;
        for (int x : adj[ca]) {
          if (x == cb) {
            dup = true;
            break;
          }
        }
        if (!dup) adj[ca].push_back(cb);
      }
    }
  }

  /* DFS topo sort skipping back edges */
  std::vector<int> out(n_cols), state(n_cols, 0);
  std::vector<std::pair<int, int>> stack;
  int out_idx = n_cols - 1;
  for (int start = 0; start < n_cols; start++) {
    if (state[start]) continue;
    stack.clear();
    stack.push_back({start, 0});
    state[start] = 1;
    while (!stack.empty()) {
      auto [node, edge_idx] = stack.back();
      stack.pop_back();
      bool pushed = false;
      for (int e = edge_idx; e < (int)adj[node].size(); e++) {
        int nxt = adj[node][e];
        if (state[nxt] == 0) {
          stack.push_back({node, e + 1});
          stack.push_back({nxt, 0});
          state[nxt] = 1;
          pushed = true;
          break;
        }
      }
      if (!pushed) {
        state[node] = 2;
        out[out_idx--] = node;
      }
    }
  }
  std::vector<int> col_order(n_cols);
  for (int i = 0; i < n_cols; i++) col_order[out[i]] = i;

  for (int i = 0; i < total; i++) out_colpos[i] = col_order[col_id[i]];
  return n_cols;
}
